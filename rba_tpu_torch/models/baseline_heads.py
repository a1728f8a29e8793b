"""The other heads (counterpart of ``rba_tpu/models/baseline_heads.py``).

- ``FPNPixelDecoder``: the plain FPN pixel decoder (``BasePixelDecoder``), a conv +
  GroupNorm(32) + ReLU output per level and a nearest top-down path; with ``encoder``
  it is ``TransformerEncoderPixelDecoder``, which runs a DETR encoder (post- or
  pre-norm, a final ``encoder_norm`` under pre-norm) on the top feature first.
- ``StandardDecoder``: MaskFormer v1's DETR decoder (``StandardTransformerDecoder``),
  deep-supervised; without its class head it is the predictor of
  ``PerPixelBaselinePlusHead``, whose queries are the classes.
- ``PerPixelBaselineHead`` (a 1x1 predictor conv on the mask features) and
  ``PerPixelBaselinePlusHead``, with their losses: cross-entropy over ``sem_seg`` of the
  ×4 upsampled logits, or PointRend's uncertainty-sampled points.

Parameter names follow the JAX pytree: ``stages.0.output.conv``, ``encoder.2.attn``,
``dec_layers.5.cross_attn``, ``mask_embed.layers.2``.  Every head runs in fp32 after
the pixel decoder's inputs, which take the pixel decoder's dtype, as in ``rba_tpu``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RbAConfig
from ..ops.nn import apply_conv, apply_group_norm, apply_linear, apply_norm, mlp_apply
from ..ops.point_sample import point_sample, top_k_indices
from ..ops.resize import resize_bilinear, resize_nearest_nhwc
from ..parallel.mesh import global_sums
from .position_encoding import sine_pos_embed
from .transformer_decoder import MultiheadAttention, mha_apply


def _conv_gn(c_in: int, c_out: int, k: int) -> nn.ModuleDict:
    return nn.ModuleDict({"conv": nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=False),
                          "gn": nn.GroupNorm(32, c_out)})


def _mlp(c: int, c_out: int) -> nn.Module:
    m = nn.Module()
    m.layers = nn.ModuleList([nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c_out)])
    return m


class EncoderLayer(nn.Module):
    """DETR's encoder layer: self-attention and a ReLU FFN."""

    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.attn = MultiheadAttention(d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model)


class DecoderLayer(nn.Module):
    """DETR's decoder layer: self-attention, cross-attention to the memory and a ReLU FFN."""

    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.cross_attn = MultiheadAttention(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model)


def _ffn(layer, x):
    return apply_linear(layer.linear2, F.relu(apply_linear(layer.linear1, x)))


def encoder_layer_apply(layer: EncoderLayer, src, pos, nheads: int, pre_norm: bool = False):
    if pre_norm:
        s2 = apply_norm(layer.norm1, src)
        q = s2 + pos
        src = src + mha_apply(layer.attn, q, q, s2, nheads)
        return src + _ffn(layer, apply_norm(layer.norm2, src))
    q = src + pos
    src = apply_norm(layer.norm1, src + mha_apply(layer.attn, q, q, src, nheads))
    return apply_norm(layer.norm2, src + _ffn(layer, src))


def decoder_layer_apply(layer: DecoderLayer, tgt, memory, query_pos, mem_pos, nheads: int, pre_norm: bool = False):
    if pre_norm:
        t2 = apply_norm(layer.norm1, tgt)
        q = t2 + query_pos
        tgt = tgt + mha_apply(layer.self_attn, q, q, t2, nheads)
        t2 = apply_norm(layer.norm2, tgt)
        tgt = tgt + mha_apply(layer.cross_attn, t2 + query_pos, memory + mem_pos, memory, nheads)
        return tgt + _ffn(layer, apply_norm(layer.norm3, tgt))
    q = tgt + query_pos
    tgt = apply_norm(layer.norm1, tgt + mha_apply(layer.self_attn, q, q, tgt, nheads))
    y = mha_apply(layer.cross_attn, tgt + query_pos, memory + mem_pos, memory, nheads)
    tgt = apply_norm(layer.norm2, tgt + y)
    return apply_norm(layer.norm3, tgt + _ffn(layer, tgt))


# ---------------------------------------------------------------------------
# FPN pixel decoders
# ---------------------------------------------------------------------------

class FPNPixelDecoder(nn.Module):
    """``BasePixelDecoder``, or with ``encoder`` ``TransformerEncoderPixelDecoder``.
    ``stages`` run top-down: the top feature's output conv first, then a lateral and an
    output conv per finer level."""

    def __init__(self, cfg: RbAConfig, in_channels: Dict[str, int], encoder: bool = False):
        super().__init__()
        pcfg, c = cfg.pixel_decoder, cfg.pixel_decoder.conv_dim
        feats = pcfg.in_features[::-1]
        self.stages = nn.ModuleList()
        for i, f in enumerate(feats):
            if i == 0:  # the top feature: no lateral; with the encoder its output conv reads conv_dim channels
                self.stages.append(nn.ModuleDict({"output": _conv_gn(c if encoder else in_channels[f], c, 3)}))
            else:
                self.stages.append(nn.ModuleDict({"lateral": _conv_gn(in_channels[f], c, 1),
                                                  "output": _conv_gn(c, c, 3)}))
        self.mask_features = nn.Conv2d(c, pcfg.mask_dim, 3, padding=1)
        self.input_proj = self.encoder = self.encoder_norm = None
        if encoder:
            self.input_proj = nn.Conv2d(in_channels[feats[0]], c, 1)
            self.encoder = nn.ModuleList(EncoderLayer(c, cfg.decoder.dim_feedforward)
                                         for _ in range(pcfg.transformer_enc_layers))
            if cfg.decoder.pre_norm:
                self.encoder_norm = nn.LayerNorm(c)


def fpn_pixel_decoder_apply(
    pd: FPNPixelDecoder,
    cfg: RbAConfig,
    features: Dict[str, torch.Tensor],  # NHWC backbone maps
    dtype=torch.float32,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], List[torch.Tensor]]:
    """(mask_features, the encoder's output or None, the first three outputs, coarsest
    first), NHWC in ``dtype``, the inputs' dtype."""
    feats = cfg.pixel_decoder.in_features[::-1]
    y = enc_feat = None
    outs: List[torch.Tensor] = []
    for stage, f in zip(pd.stages, feats):
        x = features[f].to(dtype)
        if "lateral" in stage:
            lat = apply_group_norm(stage["lateral"]["gn"], apply_conv(stage["lateral"]["conv"], x))
            y = lat + resize_nearest_nhwc(y, (lat.shape[1], lat.shape[2]))
        elif pd.encoder is not None:
            t = apply_conv(pd.input_proj, x)
            b, h, w, c = t.shape
            pos = sine_pos_embed(h, w, c, device=t.device).reshape(1, h * w, c).to(t.dtype)
            src = t.reshape(b, h * w, c)
            for layer in pd.encoder:
                src = encoder_layer_apply(layer, src, pos, cfg.decoder.nheads, cfg.decoder.pre_norm)
            if pd.encoder_norm is not None:
                src = apply_norm(pd.encoder_norm, src)
            y = enc_feat = src.reshape(b, h, w, c)
        else:
            y = x
        out = stage["output"]
        y = F.relu(apply_group_norm(out["gn"], apply_conv(out["conv"], y, padding=1)))
        outs.append(y)
    mask_features = apply_conv(pd.mask_features, outs[-1], padding=1)
    return mask_features, enc_feat, outs[:3]


def build_pixel_decoder(cfg: RbAConfig, in_channels: Dict[str, int]) -> nn.Module:
    """``SEM_SEG_HEAD.PIXEL_DECODER_NAME``'s module."""
    from .pixel_decoder import PixelDecoder

    name = cfg.pixel_decoder.name
    if name == "MSDeformAttnPixelDecoder":
        return PixelDecoder(cfg.pixel_decoder, in_channels)
    if name in ("BasePixelDecoder", "TransformerEncoderPixelDecoder"):
        return FPNPixelDecoder(cfg, in_channels, encoder=name == "TransformerEncoderPixelDecoder")
    raise NotImplementedError(f"PIXEL_DECODER_NAME {name}")


def pixel_decoder_apply(pd: nn.Module, cfg: RbAConfig, features: Dict[str, torch.Tensor], dtype=torch.float32):
    """(mask_features, the encoder's top feature, the multi-scale features) of any pixel
    decoder."""
    if isinstance(pd, FPNPixelDecoder):
        return fpn_pixel_decoder_apply(pd, cfg, features, dtype)
    from .pixel_decoder import pixel_decoder_apply as msdeform_apply

    return msdeform_apply(pd, cfg.pixel_decoder, features, dtype)


# ---------------------------------------------------------------------------
# StandardTransformerDecoder (MaskFormer v1)
# ---------------------------------------------------------------------------

class StandardDecoder(nn.Module):
    """``StandardTransformerDecoder``: ``dec_layers_total`` decoder layers over
    ``enc_layers`` encoder layers on one feature map.  ``mask_classification=False``
    leaves out the class head (the ``PerPixelBaselinePlusHead`` predictor)."""

    def __init__(self, cfg: RbAConfig, in_channels: int, mask_classification: bool = True):
        super().__init__()
        d = cfg.decoder
        c = d.hidden_dim
        self.query_embed = nn.Parameter(torch.zeros(d.num_queries, c))
        self.input_proj = nn.Conv2d(in_channels, c, 1)
        self.enc_layers = nn.ModuleList(EncoderLayer(c, d.dim_feedforward) for _ in range(d.enc_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(c, d.dim_feedforward) for _ in range(d.dec_layers_total))
        self.decoder_norm = nn.LayerNorm(c)
        self.mask_embed = _mlp(c, d.mask_dim)
        self.encoder_norm = nn.LayerNorm(c) if d.pre_norm else None  # applied even without encoder layers
        self.class_embed = nn.Linear(c, cfg.num_classes + 1) if mask_classification else None


def standard_decoder_apply(
    dec: StandardDecoder,
    cfg: RbAConfig,
    x: torch.Tensor,  # (B, H, W, C) the one input feature
    mask_features: torch.Tensor,  # (B, H4, W4, C_mask)
    deep_supervision: Optional[bool] = None,
    final_mask_layout: str = "bqhw",  # "bhwq" feeds the fused RbA kernel
) -> Dict:
    """{"pred_logits" (B, Q, K+1) where there is a class head, "pred_masks" (B, Q, H4, W4)
    or (B, H4, W4, Q), "aux_outputs": the earlier layers', first first, under deep
    supervision (default ``cfg.loss.deep_supervision``)}, in fp32."""
    d = cfg.decoder
    if deep_supervision is None:
        deep_supervision = cfg.loss.deep_supervision
    b, h, w, _ = x.shape
    c = d.hidden_dim
    pos = sine_pos_embed(h, w, c, device=x.device).reshape(1, h * w, c).expand(b, -1, -1)
    src = apply_conv(dec.input_proj, x.float()).reshape(b, h * w, c)
    for layer in dec.enc_layers:
        src = encoder_layer_apply(layer, src, pos, d.nheads, d.pre_norm)
    if dec.encoder_norm is not None:
        src = apply_norm(dec.encoder_norm, src)
    query_pos = dec.query_embed.float()[None].expand(b, -1, -1)
    tgt = torch.zeros_like(query_pos)
    hs = []
    for i, layer in enumerate(dec.dec_layers):
        tgt = decoder_layer_apply(layer, tgt, src, query_pos, pos, d.nheads, d.pre_norm)
        if deep_supervision or i == len(dec.dec_layers) - 1:
            hs.append(apply_norm(dec.decoder_norm, tgt))
    mf = mask_features.float()
    preds = []
    for i, t in enumerate(hs):
        spec = "bqc,bhwc->bhwq" if i == len(hs) - 1 and final_mask_layout == "bhwq" else "bqc,bhwc->bqhw"
        pred = {"pred_masks": torch.einsum(spec, mlp_apply(dec.mask_embed.layers, t).float(), mf)}
        if dec.class_embed is not None:
            pred["pred_logits"] = apply_linear(dec.class_embed, t)
        preds.append(pred)
    return {**preds[-1], "aux_outputs": preds[:-1]}


# ---------------------------------------------------------------------------
# per-pixel baseline heads
# ---------------------------------------------------------------------------

def plus_predictor_in_channels(cfg: RbAConfig, in_channels: Dict[str, int]) -> int:
    """The width of the v1 decoder's input, by ``transformer_in_feature``."""
    in_feat = cfg.decoder.transformer_in_feature
    if in_feat in ("transformer_encoder", "multi_scale_pixel_decoder"):
        return cfg.pixel_decoder.conv_dim
    if in_feat == "pixel_embedding":
        return cfg.pixel_decoder.mask_dim
    return in_channels[in_feat]


def standard_decoder_input(cfg: RbAConfig, features, mask_features, enc_feat) -> torch.Tensor:
    """The one feature map that ``transformer_in_feature`` hands the v1 decoder."""
    in_feat = cfg.decoder.transformer_in_feature
    if in_feat == "transformer_encoder":
        if enc_feat is None:
            raise ValueError("transformer_in_feature 'transformer_encoder' needs the TransformerEncoderPixelDecoder")
        return enc_feat
    if in_feat == "pixel_embedding":
        return mask_features
    if in_feat == "multi_scale_pixel_decoder":
        raise ValueError("StandardTransformerDecoder requires a single-feature TRANSFORMER_IN_FEATURE "
                         "(res5 / transformer_encoder / pixel_embedding), not multi_scale_pixel_decoder")
    return features[in_feat]


def per_pixel_predict(pred: nn.Module, cfg: RbAConfig, features, mask_features, enc_feat):
    """A per-pixel head's ((B, K, H/4, W/4) class logits, aux list) from the pixel decoder's
    outputs: the 1x1 conv (no aux), or the class-less v1 decoder whose queries are the
    classes (aux: its earlier layers' {"pred_masks"})."""
    if isinstance(pred, nn.Conv2d):
        return apply_conv(pred, mask_features.float()).permute(0, 3, 1, 2), []
    x = standard_decoder_input(cfg, features, mask_features, enc_feat)
    out = standard_decoder_apply(pred, cfg, x, mask_features)
    return out["pred_masks"], out["aux_outputs"]


# ---------------------------------------------------------------------------
# per-pixel baseline losses
# ---------------------------------------------------------------------------

def nearest_point_sample_labels(targets: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(B, H, W) integer labels at normalised (x, y) points with grid_sample's
    ``mode="nearest", align_corners=False`` rounding (half to even) → (B, P); a point
    outside the map reads 0."""
    b, h, w = targets.shape
    x = torch.round(coords[..., 0] * w - 0.5).long()
    y = torch.round(coords[..., 1] * h - 0.5).long()
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    idx = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
    v = torch.gather(targets.reshape(b, h * w), 1, idx)
    return torch.where(valid, v, torch.zeros_like(v))


def sem_seg_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """PointRend's semantic uncertainty over the class axis 1: second-best minus best."""
    top2 = torch.topk(torch.movedim(logits, 1, -1), 2, dim=-1).values
    return top2[..., 1] - top2[..., 0]


def _masked_ce(logp: torch.Tensor, labels: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of −log p(label) over the labels below K; labels >= K (255, the outlier label
    254) are dropped.  ``group``: the data-parallel group whose ranks hold the rest of the
    batch, over which the sum and the count are completed."""
    k = logp.shape[1]
    keep = labels < k
    picked = torch.gather(logp, 1, torch.where(keep, labels, torch.zeros_like(labels))[:, None])[:, 0]
    keep = keep.float()
    total, count = global_sums(group, (picked * keep).sum(), keep.sum())
    return -total / count.clamp_min(1.0)


def per_pixel_loss(cfg: RbAConfig, uniform: Callable, logits: torch.Tensor, targets: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Cross-entropy of (B, K, H/4, W/4) logits against (B, H, W) labels: of the logits
    upsampled ×4, or with ``cfg.loss.use_point_rend`` at PointRend's points, drawn from
    ``uniform`` (candidates, then the random points)."""
    logits = logits.float()
    targets = targets.long()
    if cfg.loss.use_point_rend:
        lc = cfg.loss
        b = logits.shape[0]
        cand = uniform((b, int(lc.train_num_points * lc.oversample_ratio), 2)).to(logits.device)
        with torch.no_grad():
            unc = sem_seg_uncertainty(point_sample(logits.detach(), cand))
        n_unc = int(lc.importance_sample_ratio * lc.train_num_points)
        n_rand = lc.train_num_points - n_unc
        idx = top_k_indices(unc, n_unc)
        coords = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 2))
        if n_rand > 0:
            coords = torch.cat([coords, uniform((b, n_rand, 2)).to(logits.device)], dim=1)
        labels = nearest_point_sample_labels(targets, coords)
        return _masked_ce(torch.log_softmax(point_sample(logits, coords), dim=1), labels, group)
    full = resize_bilinear(logits, targets.shape[-2:], align_corners=False)
    return _masked_ce(torch.log_softmax(full, dim=1), targets, group)


def per_pixel_losses(cfg: RbAConfig, uniform: Callable, logits: torch.Tensor, aux: Sequence[Dict],
                     targets: torch.Tensor, group=None) -> Dict[str, torch.Tensor]:
    """{"loss_sem_seg", "loss_sem_seg_0", ...}: the final logits' loss and each aux layer's."""
    out = {"loss_sem_seg": per_pixel_loss(cfg, uniform, logits, targets, group)}
    for i, a in enumerate(aux):
        out[f"loss_sem_seg_{i}"] = per_pixel_loss(cfg, uniform, a["pred_masks"], targets, group)
    return out
