"""Multi-scale deformable attention sampling, forward (counterpart of ``rba_tpu/ops/deform_sampling.py``).

For each (batch, query, head, level, point) the per-head value map is sampled
bilinearly at ``loc * (W, H) - 0.5`` with zero padding outside the map,
weighted by the softmaxed attention weight, and summed over levels x points.
Plain PyTorch: four integer gathers and a weighted sum per level, in fp32.
A hand kernel for it is queued in ROADMAP.md.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)


def _sample_level(
    value: torch.Tensor,  # (N, H, W, M, D) fp32
    loc: torch.Tensor,  # (N, Lq, M, P, 2) fp32, (x, y) in [0, 1]
    attn: torch.Tensor,  # (N, Lq, M, P) fp32
) -> torch.Tensor:  # (N, Lq, M, D)
    n, h, w, m, d = value.shape
    _, lq, _, p, _ = loc.shape
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx, ty = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    # (N·M, HW, D): one gather table per (batch, head)
    table = value.permute(0, 3, 1, 2, 4).reshape(n * m, h * w, d)
    out = torch.zeros(n * m, lq, d, dtype=value.dtype, device=value.device)
    for dy, dx in _CORNERS:
        xi, yi = x0i + dx, y0i + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wx = tx if dx else 1 - tx
        wy = ty if dy else 1 - ty
        wgt = (wx * wy * attn * valid).permute(0, 2, 1, 3).reshape(n * m, lq, p, 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).permute(0, 2, 1, 3).reshape(n * m, lq * p, 1)
        g = torch.gather(table, 1, idx.expand(-1, -1, d)).reshape(n * m, lq, p, d)
        out = out + (g * wgt).sum(dim=2)
    return out.reshape(n, m, lq, d).permute(0, 2, 1, 3)


def ms_deform_attn_core(
    value: torch.Tensor,  # (N, S, M, D) flattened multi-level values
    spatial_shapes: Sequence[Tuple[int, int]],  # (H, W) per level
    sampling_locations: torch.Tensor,  # (N, Lq, M, L, P, 2) in [0, 1]
    attention_weights: torch.Tensor,  # (N, Lq, M, L, P) softmaxed over L·P
) -> torch.Tensor:  # (N, Lq, M·D) fp32
    n, s, m, d = value.shape
    _, lq, _, nlevels, p, _ = sampling_locations.shape
    if nlevels != len(spatial_shapes):
        raise ValueError(f"{nlevels} levels of locations for {len(spatial_shapes)} shapes")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} do not sum to S = {s}")
    value = value.float()
    sampling_locations = sampling_locations.float()
    attention_weights = attention_weights.float()
    out = torch.zeros(n, lq, m, d, dtype=torch.float32, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        v = value[:, start : start + h * w].reshape(n, h, w, m, d)
        out = out + _sample_level(v, sampling_locations[:, :, :, lid], attention_weights[:, :, :, lid])
        start += h * w
    return out.reshape(n, lq, m * d)
