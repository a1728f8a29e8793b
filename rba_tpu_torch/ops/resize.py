"""Bilinear resize with ``F.interpolate`` semantics (counterpart of ``rba_tpu/ops/resize.py``).

The JAX package writes the resize as gathers plus a lerp to match
``F.interpolate(mode="bilinear", antialias=False)``; here that call is the op
itself.  Inputs below fp32 are resized in fp32 and cast back, as there.
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


def resize_bilinear_nhwc(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (N, H, W, C) on the H and W axes (``align_corners=False``); the result has
    x's dtype."""
    h_in, w_in = x.shape[1], x.shape[2]
    out_hw = tuple(int(s) for s in out_hw)
    if (h_in, w_in) == out_hw:
        return x
    y = x.to(_work_dtype(x)).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=out_hw, mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)
