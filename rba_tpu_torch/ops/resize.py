"""Bilinear, bicubic and nearest resizes with ``F.interpolate`` semantics (counterpart of
``rba_tpu/ops/resize.py``).

The JAX package writes the resize as gathers plus a lerp to match
``F.interpolate(mode="bilinear", antialias=False)``; here that call is the op
itself.  Inputs below fp32 are resized in fp32 and cast back, as there.  An exact
2× upsample of ``resize_bilinear_nhwc`` takes ``upsample2x_bilinear_nhwc``, whose
two passes round to ``compute_dtype``.  ``resize_nearest_nhwc`` is torch's
``mode="nearest"``.  The bicubic resize (the position tables of
ViT, MViT and Swin's ``ape``) keeps the JAX package's form, four gathered taps per
axis summed in its order with its numpy weights, so that it rounds as there.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
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


def resize_nearest_nhwc(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of (N, H, W, C) with torch ``mode="nearest"`` indices,
    src = floor(dst · in / out) clamped to the input: the FPN pixel decoder's top-down
    upsample, at any ratio."""
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = (int(s) for s in out_hw)
    if (h_in, w_in) == (h_out, w_out):
        return x
    iy = torch.as_tensor(np.minimum(np.arange(h_out) * h_in // h_out, h_in - 1), device=x.device)
    ix = torch.as_tensor(np.minimum(np.arange(w_out) * w_in // w_out, w_in - 1), device=x.device)
    return x.index_select(1, iy).index_select(2, ix)


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


@functools.lru_cache(maxsize=256)
def interp_coeffs(in_size: int, out_size: int, align_corners: bool):
    """Per output index of a linear resize: (lo, hi, frac) with torch's clamping."""
    dst = np.arange(out_size, dtype=np.float64)
    if in_size == 1:
        lo = np.zeros(out_size, np.int64)
        return lo, lo, np.zeros(out_size, np.float32)
    if align_corners:
        src = np.zeros_like(dst) if out_size == 1 else dst * (in_size - 1) / (out_size - 1)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, None)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = np.clip(src - lo, 0.0, 1.0).astype(np.float32)
    return lo, hi, frac


@functools.lru_cache(maxsize=256)
def cubic_coeffs(in_size: int, out_size: int, align_corners: bool):
    """Per output index: 4 tap indices, clamped to the border, and their fp32 weights,
    torch's bicubic (Keys' kernel with a = -0.75, no antialias)."""
    a = -0.75
    dst = np.arange(out_size, dtype=np.float64)
    if in_size == 1:
        w = np.zeros((out_size, 4), np.float64)
        w[:, 1] = 1.0
        return np.zeros((out_size, 4), np.int64), w.astype(np.float32)
    if align_corners:
        src = np.zeros_like(dst) if out_size == 1 else dst * (in_size - 1) / (out_size - 1)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    base = np.floor(src).astype(np.int64)
    x = np.abs((src - base)[:, None] - np.arange(-1, 3)[None, :])
    w = np.where(x <= 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                 np.where(x < 2.0, ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a, 0.0))
    idx = np.clip(base[:, None] + np.arange(-1, 3)[None, :], 0, in_size - 1)
    return idx, w.astype(np.float32)


def _cubic_axis(y: torch.Tensor, axis: int, out_size: int, align_corners: bool) -> torch.Tensor:
    idx, w = cubic_coeffs(y.shape[axis], out_size, align_corners)
    shape = [1] * y.ndim
    shape[axis] = out_size
    acc = None
    for j in range(4):
        tap = torch.index_select(y, axis, torch.as_tensor(idx[:, j], device=y.device))
        term = tap * torch.as_tensor(w[:, j], device=y.device).reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def _bicubic(x: torch.Tensor, axes: Tuple[int, int], out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    if (x.shape[axes[0]], x.shape[axes[1]]) == tuple(out_hw):
        return x
    y = x.to(_work_dtype(x))
    y = _cubic_axis(y, axes[0], int(out_hw[0]), align_corners)
    y = _cubic_axis(y, axes[1], int(out_hw[1]), align_corners)
    return y.to(x.dtype)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes of ``x`` (..., H, W) with torch's bicubic (a = -0.75, no
    antialias); identity at equal size, fp32 work below fp32, the result in x's dtype."""
    return _bicubic(x, (x.ndim - 2, x.ndim - 1), out_hw, align_corners)


def resize_bicubic_nhwc(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """``resize_bicubic`` on the H and W axes of (N, H, W, C)."""
    return _bicubic(x, (1, 2), out_hw, align_corners)
