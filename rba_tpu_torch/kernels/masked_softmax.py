"""Swin attention softmax with bias and shift mask: the hand kernel ``csrc/masked_softmax.cu``
and its plain version.

Replaces ``rba_tpu/ops/pallas/masked_softmax.py`` ``masked_softmax_bf16``: fp32
scores plus the relative-position bias and the optional additive shift mask,
an fp32 softmax, and the probabilities written in the output dtype.  The scores
come as (B·nW, nh, N, N), the layout of the port's q·kᵀ product; window ``w``
takes ``mask[w % nW]``.  A warp keeps one (head, row) with its bias row in
registers and walks the windows, the warps of a block share the mask row, and
rows of ``N % 4 == 0`` keys move as 16-byte loads and 8-byte stores; any other
``N <= 160`` takes the scalar layout.  The source note in the .cu file gives the
bound and the design.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _PLAIN, _build

MAX_TOKENS = 160  # keys per row the kernel takes
OUT_DTYPES = (torch.float32, torch.bfloat16)


def masked_softmax_reference(
    scores: torch.Tensor,  # (B·nW, nh, N, N) fp32
    rel_bias: torch.Tensor,  # (nh, N, N) fp32
    mask: Optional[torch.Tensor],  # (nW, N, N) fp32 additive, or None
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:  # (B·nW, nh, N, N) out_dtype
    """Plain PyTorch version of the kernel: fp32 adds and softmax, one cast at the end."""
    s = scores + rel_bias
    if mask is not None:
        bw, nh, n, _ = s.shape
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None]).reshape(bw, nh, n, n)
    return torch.softmax(s, dim=-1).to(out_dtype)


def _check(scores, rel_bias, mask, out_dtype):
    if scores.dim() != 4 or scores.shape[-1] != scores.shape[-2]:
        raise ValueError(f"scores must be (B·nW, nh, N, N), got {tuple(scores.shape)}")
    bw, nh, n, _ = scores.shape
    if n > MAX_TOKENS:
        raise ValueError(f"kernel takes N <= {MAX_TOKENS} keys, got N={n}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    if tuple(rel_bias.shape) != (nh, n, n) or rel_bias.dtype != torch.float32:
        raise ValueError(f"rel_bias must be fp32 ({nh}, {n}, {n}), got {rel_bias.dtype} {tuple(rel_bias.shape)}")
    tensors = [scores, rel_bias]
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be fp32 (nW, {n}, {n}), got {mask.dtype} {tuple(mask.shape)}")
        if bw % mask.shape[0]:
            raise ValueError(f"B·nW={bw} is not a multiple of the mask's nW={mask.shape[0]}")
        tensors.append(mask)
    for x in tensors:
        if x.device != scores.device:
            raise ValueError("scores, rel_bias and mask must be on one device")
        if not x.is_contiguous():
            raise ValueError("masked_softmax takes contiguous tensors")
    return bw, nh, n


_LAUNCH = _build.Launcher("masked_softmax", "rba_masked_softmax", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)


def takes(scores: torch.Tensor) -> bool:
    """Whether a call runs the kernel: outside ``plain_versions()``, on any device but the
    CPU (the launcher raises on one other than CUDA, and on a shape it cannot take)."""
    return scores.device.type != "cpu" and not _PLAIN.get()


def masked_softmax(
    scores: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """softmax(scores + rel_bias + mask) over the last axis, in ``out_dtype``: the hand
    kernel where ``takes`` says so (it raises on what it cannot take), else
    ``masked_softmax_reference``.  The kernel has no gradient: with grad mode on and an
    input that requires one it raises, on either path, instead of returning a result
    cut off from the graph."""
    _build.refuse_grad("masked_softmax (Kernel C)", scores, rel_bias, mask)
    if not takes(scores):
        return masked_softmax_reference(scores, rel_bias, mask, out_dtype)
    if scores.device.type != "cuda":
        raise ValueError(f"masked_softmax runs on cuda or cpu, not {scores.device}")
    bw, nh, n = _check(scores, rel_bias, mask, out_dtype)
    out = torch.empty(bw, nh, n, n, dtype=out_dtype, device=scores.device)
    _LAUNCH(masked_softmax, scores.device, scores.data_ptr(), rel_bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), bw, nh, n,
            1 if mask is None else mask.shape[0], int(out_dtype == torch.bfloat16))
    return out


masked_softmax.launches = 0  # kernel launches since the last reset
