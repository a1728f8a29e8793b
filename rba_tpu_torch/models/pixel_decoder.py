"""MSDeformAttn pixel decoder (counterpart of ``rba_tpu/models/pixel_decoder.py``).

Runs in fp32, as the reference pins it, or with ``dtype=torch.bfloat16`` (the
``fast_serving`` mode) in ``rba_tpu``'s bf16 mode: the inputs of its convs are cast
to bf16, and each op then takes PyTorch's type promotion, which is jnp's here (a bf16
operand meeting an fp32 one gives fp32).  So the input projection, the position
embedding, the first encoder layer's three input projections, the FPN lateral convs
and the 2× upsample's passes run in bf16; the sampling returns fp32, and from there
the encoder, the FPN output convs and ``mask_features`` run in fp32.  Parameter names
follow the JAX pytree:
``input_proj.0.conv``, ``transformer.encoder.layers.3.self_attn.value_proj``,
``fpn.1.output.gn``, ``mask_features``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import PixelDecoderConfig
from ..ops.deform_sampling import ms_deform_attn_core
from ..ops.nn import apply_conv, apply_group_norm, apply_linear, apply_norm
from ..ops.resize import resize_bilinear_nhwc
from .position_encoding import sine_pos_embed


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def offset_bias_grid(self) -> np.ndarray:
        """Directional init of the sampling-offset bias (reference ms_deform_attn.py:66-80)."""
        nh, nl, npts = self.n_heads, self.n_levels, self.n_points
        thetas = np.arange(nh, dtype=np.float32) * (2.0 * np.pi / nh)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid.reshape(nh, 1, 1, 2), (1, nl, npts, 1))
        grid *= np.arange(1, npts + 1, dtype=np.float32)[None, None, :, None]
        return grid.reshape(-1)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model)


class _DeformableTransformer(nn.Module):
    def __init__(self, cfg: PixelDecoderConfig):
        super().__init__()
        nlv = cfg.num_feature_levels
        self.level_embed = nn.Parameter(torch.zeros(nlv, cfg.conv_dim))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            EncoderLayer(cfg.conv_dim, cfg.transformer_dim_feedforward, nlv, cfg.transformer_nheads,
                         cfg.enc_n_points)
            for _ in range(cfg.transformer_enc_layers)
        )


def _conv_gn(c_in: int, c_out: int, k: int, bias: bool) -> nn.ModuleDict:
    return nn.ModuleDict({"conv": nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=bias),
                          "gn": nn.GroupNorm(32, c_out)})


class PixelDecoder(nn.Module):
    def __init__(self, cfg: PixelDecoderConfig, in_channels: Dict[str, int]):
        super().__init__()
        self.input_proj = nn.ModuleList(
            _conv_gn(in_channels[f], cfg.conv_dim, 1, bias=True) for f in cfg.transformer_in_features[::-1]
        )
        self.transformer = _DeformableTransformer(cfg)
        n_fpn = len(cfg.in_features) - len(cfg.transformer_in_features)
        self.fpn = nn.ModuleList(
            nn.ModuleDict({
                "lateral": _conv_gn(in_channels[f], cfg.conv_dim, 1, bias=False),
                "output": _conv_gn(cfg.conv_dim, cfg.conv_dim, 3, bias=False),
            })
            for f in cfg.in_features[:n_fpn]
        )
        self.mask_features = nn.Conv2d(cfg.conv_dim, cfg.mask_dim, 1)


def ms_deform_attn_apply(
    attn: MSDeformAttn,
    query: torch.Tensor,  # (N, Lq, C) content + position
    reference_points: torch.Tensor,  # (N, Lq, L, 2) in [0, 1]
    value_input: torch.Tensor,  # (N, S, C)
    spatial_shapes: Sequence[Tuple[int, int]],
    cfg: PixelDecoderConfig,
) -> torch.Tensor:
    n, lq, c = query.shape
    nh, nl, npts = attn.n_heads, len(spatial_shapes), attn.n_points
    value = apply_linear(attn.value_proj, value_input).reshape(n, -1, nh, c // nh)
    offsets = apply_linear(attn.sampling_offsets, query).reshape(n, lq, nh, nl, npts, 2)
    aw = apply_linear(attn.attention_weights, query).reshape(n, lq, nh, nl * npts)
    aw = torch.softmax(aw.float(), dim=-1).reshape(n, lq, nh, nl, npts)
    normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32, device=query.device)
    loc = reference_points[:, :, None, :, None, :] + offsets / normalizer[None, None, None, :, None, :]
    out = ms_deform_attn_core(value, spatial_shapes, loc, aw, method=cfg.sampling_method,
                              sampling_dtype=cfg.sampling_dtype, onehot_cap=cfg.sampling_onehot_cap)
    return apply_linear(attn.output_proj, out)


def encoder_layer_apply(layer: EncoderLayer, src, pos, reference_points, spatial_shapes, cfg: PixelDecoderConfig):
    src2 = ms_deform_attn_apply(layer.self_attn, src + pos, reference_points, src, spatial_shapes, cfg)
    src = apply_norm(layer.norm1, src + src2)
    ffn = apply_linear(layer.linear2, F.relu(apply_linear(layer.linear1, src)))
    return apply_norm(layer.norm2, src + ffn)


@functools.lru_cache(maxsize=64)
def _reference_points_np(spatial_shapes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """(ΣHW, L, 2) center-grid reference points; valid ratios are all ones in the
    live path, so the grid is broadcast across levels."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, 0)
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1))


def pixel_decoder_apply(
    model: PixelDecoder,
    cfg: PixelDecoderConfig,
    features: Dict[str, torch.Tensor],  # NHWC backbone maps
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(mask_features, transformer encoder output, multi-scale features), all NHWC fp32.
    ``dtype`` is the inputs' dtype: fp32, or bf16 in ``fast_serving`` (see the module's
    docstring)."""
    srcs, poss, spatial_shapes = [], [], []
    for i, f in enumerate(cfg.transformer_in_features[::-1]):
        proj = model.input_proj[i]
        y = apply_group_norm(proj["gn"], apply_conv(proj["conv"], features[f].to(dtype)))
        srcs.append(y)
        n, h, w, c = y.shape
        poss.append(sine_pos_embed(h, w, c, dtype=dtype, device=y.device))
        spatial_shapes.append((h, w))

    n, c = srcs[0].shape[0], srcs[0].shape[-1]
    src_flat = torch.cat([s.reshape(n, -1, c) for s in srcs], dim=1)
    lvl = model.transformer.level_embed.to(dtype)
    pos_flat = torch.cat([(poss[i] + lvl[i]).reshape(1, -1, c) for i in range(len(srcs))], dim=1)
    ref_pts = torch.as_tensor(_reference_points_np(tuple(spatial_shapes)), device=src_flat.device)
    ref_pts = ref_pts[None].expand(n, -1, -1, -1)

    y = src_flat
    for layer in model.transformer.encoder.layers:
        y = encoder_layer_apply(layer, y, pos_flat, ref_pts, spatial_shapes, cfg)

    out: List[torch.Tensor] = []
    start = 0
    for h, w in spatial_shapes:
        out.append(y[:, start : start + h * w].reshape(n, h, w, c))
        start += h * w

    fpn_feats = cfg.in_features[: len(model.fpn)]
    for f, p in zip(fpn_feats[::-1], list(model.fpn)[::-1]):
        lat = apply_group_norm(p["lateral"]["gn"], apply_conv(p["lateral"]["conv"], features[f].to(dtype)))
        up = resize_bilinear_nhwc(out[-1], (lat.shape[1], lat.shape[2]), compute_dtype=dtype)
        z = apply_conv(p["output"]["conv"], lat + up)
        out.append(F.relu(apply_group_norm(p["output"]["gn"], z)))

    mask_features = apply_conv(model.mask_features, out[-1])
    return mask_features, out[0], out[: cfg.num_feature_levels]
