"""Swin window attention: the hand kernel ``csrc/window_attention.cu`` and its plain version.

Replaces the Pallas kernels of ``rba_tpu/ops/pallas/window_attention.py``
(``window_attention_fused``, ``_v2``, ``_v3``) with the v2 interface: fused qkv
(B·nW, N, 3C) in, (B·nW, N, C) out, heads split inside.

bf16 runs on the tensor cores (``mma.sync``: q·kᵀ and p·v in bf16 with fp32
sums, the scores and the softmax in fp32 registers, the probabilities rounded to
bf16 as the Pallas kernels round them).  The kernel scales the fp32 product,
``(q·k)·scale``, where Pallas and the plain version scale q first, ``(q·scale)·k``:
the two differ by a few fp32 ulps of a logit.  fp32 runs on CUDA cores, in full
fp32.  The source note in the .cu file gives the bound and both designs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.profiling import WINDOW_ATTENTION, span
from . import _PLAIN, _build

# (N, hd) the kernel takes: N <= 160 keys per window, head dims 16 and 32
MAX_TOKENS = 160
HEAD_DIMS = (16, 32)


def window_attention_reference(
    qkv: torch.Tensor,  # (B·nW, N, 3C)
    rel_bias: torch.Tensor,  # (nh, N, N) fp32
    mask: Optional[torch.Tensor],  # (nW, N, N) fp32 additive, or None
    nh: int,
    scale: float,
) -> torch.Tensor:  # (B·nW, N, C), qkv's dtype
    """Plain PyTorch version of the kernel: fp32 math throughout, except that with
    bf16 inputs the probabilities are rounded to bf16 before the fp32 ``· v`` sum,
    as the Pallas kernels round them."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    q, k, v = qkv.float().reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)  # (bw, nh, N, hd)
    s = torch.matmul(q * scale, k.transpose(-1, -2)) + rel_bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, nh, n, n) + mask.float()[None, :, None]).reshape(bw, nh, n, n)
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    out = torch.matmul(p, v)  # (bw, nh, N, hd)
    return out.permute(0, 2, 1, 3).reshape(bw, n, c).to(qkv.dtype)


def _check(qkv, rel_bias, mask, nh):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * nh):
        raise ValueError(f"qkv must be (B·nW, N, 3C) with C divisible by nh={nh}, got {tuple(qkv.shape)}")
    bw, n, c3 = qkv.shape
    hd = c3 // 3 // nh
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if n > MAX_TOKENS or hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes N <= {MAX_TOKENS} and hd in {HEAD_DIMS}, got N={n}, hd={hd}")
    if tuple(rel_bias.shape) != (nh, n, n) or rel_bias.dtype != torch.float32:
        raise ValueError(f"rel_bias must be fp32 ({nh}, {n}, {n}), got {rel_bias.dtype} {tuple(rel_bias.shape)}")
    tensors = [qkv, rel_bias]
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be fp32 (nW, {n}, {n}), got {mask.dtype} {tuple(mask.shape)}")
        if bw % mask.shape[0]:
            raise ValueError(f"B·nW={bw} is not a multiple of the mask's nW={mask.shape[0]}")
        tensors.append(mask)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("qkv, rel_bias and mask must be 16-byte aligned (the kernel loads them 16 bytes at a time)")
    for t in tensors:
        if t.device != qkv.device:
            raise ValueError("qkv, rel_bias and mask must be on one device")
        if not t.is_contiguous():
            raise ValueError("window_attention takes contiguous tensors")
    return bw, n, hd


_LAUNCH = _build.Launcher("window_attention", "rba_window_attention",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int])


def takes(qkv: torch.Tensor) -> bool:
    """Whether a call runs the kernel: outside ``plain_versions()``, on any device but the
    CPU (the launcher raises on one other than CUDA, and on a shape it cannot take)."""
    return qkv.device.type != "cpu" and not _PLAIN.get()


def window_attention(
    qkv: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    nh: int,
    scale: float,
) -> torch.Tensor:
    """Window attention of fused qkv: the hand kernel where ``takes`` says so (it raises
    on what it cannot take), else ``window_attention_reference``.  The kernel has no
    gradient: with grad mode on and an input that requires one it raises, on either
    path, instead of returning a result cut off from the graph.  Each call, on either
    path, is one ``window_attention`` span."""
    with span(WINDOW_ATTENTION):
        _build.refuse_grad("window_attention (Kernel A)", qkv, rel_bias, mask)
        if not takes(qkv):
            return window_attention_reference(qkv, rel_bias, mask, nh, scale)
        if qkv.device.type != "cuda":
            raise ValueError(f"window_attention runs on cuda or cpu, not {qkv.device}")
        bw, n, hd = _check(qkv, rel_bias, mask, nh)
        out = torch.empty(bw, n, nh * hd, dtype=qkv.dtype, device=qkv.device)
        _LAUNCH(window_attention, qkv.device, qkv.data_ptr(), rel_bias.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(), bw, n, nh, hd,
                1 if mask is None else mask.shape[0], float(scale), int(qkv.dtype == torch.bfloat16))
        return out


window_attention.launches = 0  # kernel launches since the last reset
