"""Exact linear-sum assignment on the card: the hand kernel ``csrc/lsap.cu`` (Kernel E).

``rba_tpu`` keeps the matcher's Hungarian assignment on the device as a
Jonker–Volgenant solver in ``lax`` while-loops (``rba_tpu/ops/lsap.py``), so that its
train step never waits on the host.  Eager PyTorch has no device-side loop, so the port
runs the same solver as one CUDA kernel: a block of one warp per matrix, the columns
over the lanes, the rows in order.  Its assignment equals the plain version's
(``ops/lsap.py``) exactly, and ``train/matcher.py`` asks ``takes`` which of the two
runs.  The source note in the .cu file gives the bound and the design.
"""
from __future__ import annotations

import ctypes

import torch

from . import _PLAIN, _build

MAX_COLS = 1024  # columns (and rows) of a matrix the kernel takes


def _check(cost: torch.Tensor):
    if cost.dim() != 3:
        raise ValueError(f"cost must be (B, R, C), got {tuple(cost.shape)}")
    b, r, c = cost.shape
    if r > c or c > MAX_COLS or r < 1 or b < 1:
        raise ValueError(f"the LSAP kernel takes 1 <= R <= C <= {MAX_COLS} and B >= 1, got B={b}, R={r}, C={c}")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("batched_linear_sum_assignment takes a contiguous cost")
    return b, r, c


_LAUNCH = _build.Launcher("lsap", "rba_lsap", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)


def takes(cost: torch.Tensor) -> bool:
    """Whether an assignment runs the kernel: outside ``plain_versions()``, on any device
    but the CPU (the launcher raises on one other than CUDA, on a shape it cannot take
    and on a cost that needs a gradient)."""
    return cost.device.type != "cpu" and not _PLAIN.get()


def batched_linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """(B, R, C) fp32 cost, R <= C → (B, R) int32 column of each row, the exact minimum
    assignment with ``rba_tpu``'s tie order, in one launch on the cost's CUDA device; it
    raises on any other device: its plain version is ``ops/lsap.py``'s."""
    if cost.device.type != "cuda":
        raise ValueError(f"batched_linear_sum_assignment runs on cuda, not {cost.device}")
    if cost.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the LSAP kernel has no gradient: call it on a detached cost")
    b, r, c = _check(cost)
    out = torch.empty(b, r, dtype=torch.int32, device=cost.device)
    _LAUNCH(batched_linear_sum_assignment, cost.device, cost.data_ptr(), out.data_ptr(), b, r, c)
    return out


batched_linear_sum_assignment.launches = 0  # kernel launches since the last reset
