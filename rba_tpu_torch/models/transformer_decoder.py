"""Masked-attention transformer decoder, inference (counterpart of ``rba_tpu/models/transformer_decoder.py``).

Batch-first tensors, additive fp32 masks of ``NEG_INF`` in place of boolean
-inf ones, NHWC mask features.  Rows whose mask would block every key are
unmasked, as in the reference.  Only the inference form (``need_aux=False``)
is ported; the aux heads belong to the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DecoderConfig
from ..ops.nn import apply_conv, apply_linear, apply_norm, mlp_apply
from ..ops.resize import resize_bilinear_nhwc
from .position_encoding import sine_pos_embed

NEG_INF = -1e9


class MultiheadAttention(nn.Module):
    """Parameters of torch ``nn.MultiheadAttention`` as the JAX pytree names them."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)


class BatchNormStats(nn.Module):
    """An inference batch norm's parameters as the JAX pytree names them: ``weight``
    (``scale``), ``bias``, and the running ``mean`` and ``var``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))


def _attn_layer(d_model: int) -> nn.ModuleDict:
    return nn.ModuleDict({"attn": MultiheadAttention(d_model), "norm": nn.LayerNorm(d_model)})


class MaskedDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, num_classes: int, in_channels: int):
        super().__init__()
        c = cfg.hidden_dim
        self.query_feat = nn.Parameter(torch.zeros(cfg.num_queries, c))
        self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, c))
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, c))
        self.decoder_norm = nn.LayerNorm(c)
        self.class_embed = nn.Linear(c, num_classes + 1)
        self.mask_embed = nn.Module()
        self.mask_embed.layers = nn.ModuleList([nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, cfg.mask_dim)])
        if in_channels != c or cfg.enforce_input_project:
            self.input_proj = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for _ in range(cfg.num_feature_levels))
        else:
            self.input_proj = None
        self.cross_layers = nn.ModuleList(_attn_layer(c) for _ in range(cfg.dec_layers))
        self.self_layers = nn.ModuleList(_attn_layer(c) for _ in range(cfg.dec_layers))
        self.ffn_layers = nn.ModuleList(
            nn.ModuleDict({"linear1": nn.Linear(c, cfg.dim_feedforward),
                           "linear2": nn.Linear(cfg.dim_feedforward, c), "norm": nn.LayerNorm(c)})
            for _ in range(cfg.dec_layers)
        )
        # DenseHybrid's BN -> ReLU -> 1x1 conv head on the mask features: (inlier, outlier) logits
        self.ood_pred = (nn.ModuleDict({"bn": BatchNormStats(c), "conv": nn.Conv2d(c, 2, 1)})
                         if cfg.ood_prediction else None)


def mha_apply(
    attn: MultiheadAttention,
    query: torch.Tensor,  # (B, Lq, C)
    key: torch.Tensor,  # (B, Lk, C)
    value: torch.Tensor,  # (B, Lk, C)
    num_heads: int,
    attn_mask: Optional[torch.Tensor] = None,  # (B, 1 or nh, Lq, Lk) additive fp32
) -> torch.Tensor:
    """``nn.MultiheadAttention`` semantics with an additive mask, softmax in fp32."""
    b, lq, c = query.shape
    lk = key.shape[1]
    hd = c // num_heads
    w, bias = attn.in_proj.weight, attn.in_proj.bias
    q = F.linear(query, w[:c].to(query.dtype), bias[:c].to(query.dtype)).reshape(b, lq, num_heads, hd)
    k = F.linear(key, w[c : 2 * c].to(key.dtype), bias[c : 2 * c].to(key.dtype)).reshape(b, lk, num_heads, hd)
    v = F.linear(value, w[2 * c :].to(value.dtype), bias[2 * c :].to(value.dtype)).reshape(b, lk, num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q * hd**-0.5, k).float()
    if attn_mask is not None:
        s = s + attn_mask
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, lq, c)
    return apply_linear(attn.out_proj, out)


def _blocked_to_mask(am: torch.Tensor) -> torch.Tensor:
    """(B, Q, h, w) mask logits -> (B, 1, Q, h·w) additive mask, fully blocked rows unmasked."""
    blocked = (torch.sigmoid(am) < 0.5).reshape(am.shape[0], am.shape[1], -1)
    blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=torch.float32, device=am.device)
    return torch.where(blocked, torch.full_like(zero, NEG_INF), zero)[:, None]


def _attn_mask_only(
    dec: MaskedDecoder,
    output: torch.Tensor,  # (B, Q, C)
    mask_features_small: torch.Tensor,  # (B, h, w, C_mask) resized to the level
) -> torch.Tensor:
    """Attention mask of a non-final layer, computed at the level resolution (resize
    commutes with the mask einsum)."""
    mask_embed = mlp_apply(dec.mask_embed.layers, apply_norm(dec.decoder_norm, output))
    am = torch.einsum("bqc,bhwc->bqhw", mask_embed.float(), mask_features_small.float())
    return _blocked_to_mask(am)


def _prediction_heads(
    dec: MaskedDecoder,
    output: torch.Tensor,  # (B, Q, C)
    mask_features: torch.Tensor,  # (B, H, W, C_mask)
    final_mask_layout: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class logits (B, Q, K+1) and fp32 mask logits in ``final_mask_layout``."""
    dec_out = apply_norm(dec.decoder_norm, output)
    outputs_class = apply_linear(dec.class_embed, dec_out)
    mask_embed = mlp_apply(dec.mask_embed.layers, dec_out)
    spec = "bqc,bhwc->bhwq" if final_mask_layout == "bhwq" else "bqc,bhwc->bqhw"
    return outputs_class, torch.einsum(spec, mask_embed.float(), mask_features.float())


def ood_pred_apply(head: nn.ModuleDict, mask_features: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) mask features → (B, 2, H, W) DenseHybrid logits: BN (eps 1e-5) → ReLU →
    1x1 conv, in fp32."""
    bn = head["bn"]
    x = (mask_features.float() - bn.mean) * torch.rsqrt(bn.var + 1e-5)
    x = x * bn.weight + bn.bias
    return apply_conv(head["conv"], F.relu(x)).permute(0, 3, 1, 2)


def decoder_apply(
    dec: MaskedDecoder,
    cfg: DecoderConfig,
    x: Sequence[torch.Tensor],  # multi-scale NHWC features, one per level
    mask_features: torch.Tensor,  # (B, H/4, W/4, C_mask)
    final_mask_layout: str = "bqhw",  # "bhwq" feeds the fused RbA kernel
    need_aux: bool = False,
) -> Dict:
    """Final class logits (B, Q, K+1) and mask logits, (B, Q, H, W) or (B, H, W, Q), and
    with the DenseHybrid head its (B, 2, H, W) ``ood_pred`` logits.  Runs in fp32, as the
    JAX package's MaskFormer forward runs it."""
    if need_aux:
        raise NotImplementedError("need_aux=True (deep-supervision outputs) belongs to the training slice")
    if len(x) != cfg.num_feature_levels:
        raise ValueError(f"{len(x)} feature maps for {cfg.num_feature_levels} levels")
    if final_mask_layout not in ("bqhw", "bhwq"):
        raise ValueError(f"final_mask_layout {final_mask_layout!r}")
    b = x[0].shape[0]
    c = cfg.hidden_dim
    srcs, poss, sizes = [], [], []
    for i in range(cfg.num_feature_levels):
        _, h, w, _ = x[i].shape
        sizes.append((h, w))
        poss.append(sine_pos_embed(h, w, c, dtype=torch.float32, device=x[i].device).reshape(1, h * w, c))
        feat = x[i].float()
        if dec.input_proj is not None:
            feat = apply_conv(dec.input_proj[i], feat)
        srcs.append(feat.reshape(b, h * w, -1) + dec.level_embed[i].float())

    query_embed = dec.query_embed.float()[None].expand(b, -1, -1)
    output = dec.query_feat.float()[None].expand(b, -1, -1)

    mf_small = {}

    def small_mf(hw):
        if hw not in mf_small:
            mf_small[hw] = resize_bilinear_nhwc(mask_features.float(), hw)
        return mf_small[hw]

    attn_mask = _attn_mask_only(dec, output, small_mf(sizes[0]))
    for i in range(cfg.dec_layers):
        lvl = i % cfg.num_feature_levels
        layer = dec.cross_layers[i]
        y = mha_apply(layer["attn"], output + query_embed, srcs[lvl] + poss[lvl], srcs[lvl], cfg.nheads,
                      attn_mask=attn_mask)
        output = apply_norm(layer["norm"], output + y)

        layer = dec.self_layers[i]
        q = output + query_embed
        output = apply_norm(layer["norm"], output + mha_apply(layer["attn"], q, q, output, cfg.nheads))

        layer = dec.ffn_layers[i]
        y = apply_linear(layer["linear2"], F.relu(apply_linear(layer["linear1"], output)))
        output = apply_norm(layer["norm"], output + y)

        if i < cfg.dec_layers - 1:
            attn_mask = _attn_mask_only(dec, output, small_mf(sizes[(i + 1) % cfg.num_feature_levels]))
    outputs_class, outputs_mask = _prediction_heads(dec, output, mask_features, final_mask_layout)
    out = {"pred_logits": outputs_class, "pred_masks": outputs_mask}
    if dec.ood_pred is not None:
        out["ood_pred"] = ood_pred_apply(dec.ood_pred, mask_features)
    return out
