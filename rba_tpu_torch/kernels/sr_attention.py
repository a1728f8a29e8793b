"""MiT's spatial-reduction attention core on the card: the hand kernel
``csrc/sr_attention.cu`` (Kernel G).

It replaces no Pallas kernel: ``rba_tpu`` computes the core in plain jnp, which XLA
fuses, while eager PyTorch runs the port's chain (``models/mix_transformer.py``
``sr_attention_plain``) as six to eight operations that write every block's whole score
matrix to device memory four times.  The kernel computes that chain, with its roundings,
in one launch per block, reading q and k, v straight from the linears' outputs and
writing the output in the layout ``proj`` takes.  ``models/mix_transformer.py`` runs the
one ``takes`` names: the plain chain stays for the CPU, for fp32, for training (the
kernel has no gradient) and for head dims the kernel is not built for.  The source note
in the .cu file gives the bound and the design.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _PLAIN, _build

HEAD_DIMS = (32, 64)  # per-head channels the kernel is built for: 32 on MiT-B0, 64 on MiT-B1…B5
MAX_IMAGE_HEADS = 65535  # images × heads: the launch's second grid dimension
# hd**-0.5 rounded to bf16, as models/vit.py scaled rounds it
SCALES = {hd: torch.tensor(hd**-0.5, dtype=torch.bfloat16).item() for hd in HEAD_DIMS}


def takes(device: torch.device, dtype: torch.dtype, needs_grad: bool, head_dim: int) -> bool:
    """Whether a block's attention core runs the kernel: outside ``plain_versions()``, its
    tensors are on CUDA in bf16, autograd does not need the core's gradient, and the
    kernel is built for the head dim (``HEAD_DIMS``)."""
    return (device.type == "cuda" and dtype == torch.bfloat16 and not needs_grad and head_dim in HEAD_DIMS
            and not _PLAIN.get())


def _check(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    """(B, N, M, head dim) of a call the kernel takes; raises on any other."""
    if q.dim() != 3 or kv.dim() != 3:
        raise ValueError(f"q must be (B, N, C) and kv (B, M, 2C), got {tuple(q.shape)} and {tuple(kv.shape)}")
    b, n, c = q.shape
    m = kv.shape[1]
    if kv.shape[0] != b or kv.shape[2] != 2 * c or num_heads < 1 or c % num_heads:
        raise ValueError(f"kv {tuple(kv.shape)} does not match q {tuple(q.shape)} at {num_heads} heads")
    if min(b, n, m) < 1:
        raise ValueError(f"empty call: q {tuple(q.shape)}, kv {tuple(kv.shape)}")
    hd = c // num_heads
    if hd not in HEAD_DIMS or b * num_heads > MAX_IMAGE_HEADS:
        raise ValueError(f"the attention kernel takes head dims {HEAD_DIMS} and at most {MAX_IMAGE_HEADS} images "
                         f"x heads, got head dim {hd} and {b} x {num_heads}")
    for name, x in (("q", q), ("kv", kv)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernel takes bfloat16 {name}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the attention kernel takes a contiguous {name}")
        if x.data_ptr() % 16:
            raise ValueError(f"the attention kernel reads rows as 16-byte words: {name} must start on 16 bytes")
    return b, n, m, hd


_LAUNCH = _build.Launcher("sr_attention", "rba_sr_attention",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float])


def sr_attention(
    q: torch.Tensor,  # (B, N, C) bf16, the q linear's output
    kv: torch.Tensor,  # (B, M, 2C) bf16, the kv linear's output: k, then v
    num_heads: int,
    out: Optional[torch.Tensor] = None,  # (B, N, C) bf16, contiguous, to write into
) -> torch.Tensor:  # (B, N, C) bf16: ``out`` where given
    """softmax(q·kᵀ · bf16(hd^-0.5))·v per image and head, rounded as
    ``sr_attention_plain`` rounds it, in one launch, into ``out`` where given (a CUDA
    graph's fixed buffer) or a new tensor.  Checks the arguments first, then launches on
    their CUDA device or raises: it has no plain fallback and no gradient."""
    b, n, m, hd = _check(q, kv, num_heads)
    device = q.device
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype or out.device != device
                            or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous {q.dtype} tensor of q's shape {tuple(q.shape)} on {device}, "
                         f"starting on 16 bytes, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if device.type != "cuda" or kv.device != device:
        raise ValueError(f"sr_attention runs on one cuda device, got {device} and {kv.device}")
    _build.refuse_grad("sr_attention", q, kv)
    if out is None:
        out = torch.empty_like(q)
    _LAUNCH(sr_attention, device, q.data_ptr(), kv.data_ptr(), out.data_ptr(), b, n, m, num_heads, hd, SCALES[hd])
    return out


sr_attention.launches = 0  # kernel launches since the last reset
