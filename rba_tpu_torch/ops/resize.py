"""Bilinear resize with ``F.interpolate`` semantics (counterpart of ``rba_tpu/ops/resize.py``).

The JAX package writes the resize as gathers plus a lerp to match
``F.interpolate(mode="bilinear", antialias=False)``; here that call is the op
itself.  Inputs below fp32 are resized in fp32 and cast back, as there.  An exact
2× upsample of ``resize_bilinear_nhwc`` takes ``upsample2x_bilinear_nhwc``, whose
two passes round to ``compute_dtype``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _work_dtype(x: torch.Tensor):
    return x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes of ``x`` (..., H, W) to ``out_hw``; the result has x's dtype."""
    h_in, w_in = x.shape[-2:]
    out_hw = tuple(int(s) for s in out_hw)
    if (h_in, w_in) == out_hw:
        return x
    lead = x.shape[:-2]
    y = x.to(_work_dtype(x)).reshape(1, -1, h_in, w_in)
    y = F.interpolate(y, size=out_hw, mode="bilinear", align_corners=align_corners)
    return y.reshape(*lead, *out_hw).to(x.dtype)


def upsample2x_bilinear_nhwc(x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Exact 2× bilinear upsample (``align_corners=False``) of (N, H, W, C), as
    ``rba_tpu.ops.resize.upsample2x_bilinear_nhwc`` computes it: edges replicated,
    out[2j] = 0.25·in[j−1] + 0.75·in[j] and out[2j+1] = 0.75·in[j] + 0.25·in[j+1]; the H
    pass and then the W pass, each in fp32 and rounded to ``compute_dtype`` (default:
    x's dtype, fp32 below fp32), and the result cast back to x's dtype."""
    dt = compute_dtype or _work_dtype(x)
    y = x.to(dt).permute(0, 3, 1, 2)
    h, w = y.shape[-2:]
    for size in ((2 * h, w), (2 * h, 2 * w)):
        y = F.interpolate(y.float(), size=size, mode="bilinear", align_corners=False).to(dt)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_bilinear_nhwc(x: torch.Tensor, out_hw: Tuple[int, int], compute_dtype=None) -> torch.Tensor:
    """Resize (N, H, W, C) on the H and W axes (``align_corners=False``); the result has
    x's dtype.  ``compute_dtype`` rounds the input to it first; an exact 2× upsample
    rounds each pass to it too (``upsample2x_bilinear_nhwc``)."""
    h_in, w_in = x.shape[1], x.shape[2]
    out_hw = tuple(int(s) for s in out_hw)
    if (h_in, w_in) == out_hw:
        return x
    if out_hw == (2 * h_in, 2 * w_in):
        return upsample2x_bilinear_nhwc(x, compute_dtype)
    y = x.to(compute_dtype or x.dtype)
    y = y.to(_work_dtype(y)).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=out_hw, mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)
