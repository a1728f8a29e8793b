"""Fused Swin MLP block tail: the hand kernel ``csrc/fused_mlp.cu`` and its plain version.

Replaces ``rba_tpu/ops/pallas/fused_mlp.py`` ``fused_mlp_residual``:
``x + fc2(gelu(fc1(LayerNorm(x))))`` with the (T, 4C) hidden tensor kept on
chip.  Weights and biases come as the port's fp32 parameters in ``nn.Linear``'s
(out, in) layout.  The dtype placement is the Pallas kernel's, which the plain
version repeats: LayerNorm moments in fp32, each product accumulated in fp32 and
rounded to the compute dtype before its bias add, exact (erf) gelu in fp32
rounded, the residual add in the compute dtype.

bf16 runs on the tensor cores (``mma.sync``, bf16 products with fp32 sums): the
wrapper hands the kernel bf16 copies of ``w1`` and ``w2``, rounded as the plain
version rounds them, which the kernel stages with ``cp.async``.  fp32 runs on
CUDA cores, in full fp32.  The source note in the .cu file gives the bound and
both designs.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _PLAIN, _build

DTYPES = (torch.float32, torch.bfloat16)
EPS = 1e-5  # the Pallas kernel's LayerNorm epsilon


def supports(t: int, c: int) -> bool:
    """Capacity: the kernel takes C a multiple of 128 up to 512, any token count T.
    A copy of ``rba_tpu/ops/pallas/fused_mlp.py`` ``supports`` (``fused_mlp.py:143-145``, through
    ``_pick_blocking``, ``:54-75``)."""
    return c % 128 == 0 and c <= 512


def beneficial(t: int, c: int) -> bool:
    """Policy of the Swin dispatch: the fused kernel runs where C <= 256, the Swin-B
    stages 0 and 1.  A copy of ``rba_tpu/ops/pallas/fused_mlp.py`` ``beneficial``
    (``fused_mlp.py:148-154``), whose C = 512 exclusion was measured on a TPU; the
    port keeps the rule so that both packages take the kernel on the same blocks."""
    return c <= 256 and supports(t, c)


def fused_mlp_residual_reference(
    x: torch.Tensor,  # (..., C) compute dtype
    gamma: torch.Tensor,  # (C,) LayerNorm weight
    beta: torch.Tensor,  # (C,) LayerNorm bias
    w1: torch.Tensor,  # (4C, C) fc1 weight
    b1: torch.Tensor,  # (4C,)
    w2: torch.Tensor,  # (C, 4C) fc2 weight
    b2: torch.Tensor,  # (C,)
) -> torch.Tensor:  # (..., C) x's dtype
    """Plain PyTorch version of the kernel, with its dtype placement."""
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y32 = (x32 - mean) * torch.rsqrt(var + EPS)
    y = (y32 * gamma.to(dt).float() + beta.to(dt).float()).to(dt)
    h = F.linear(y.float(), w1.to(dt).float()).to(dt) + b1.to(dt)
    h = F.gelu(h.float()).to(dt)
    o = F.linear(h.float(), w2.to(dt).float()).to(dt) + b2.to(dt)
    return x + o


def _check(x, gamma, beta, w1, b1, w2, b2):
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if c == 0 or not supports(x.numel() // c, c):
        raise ValueError(f"kernel takes C a multiple of 128 up to 512, got C={c}")
    if x.numel() == 0:
        raise ValueError("x holds no tokens")
    shapes = {"gamma": (c,), "beta": (c,), "w1": (4 * c, c), "b1": (4 * c,), "w2": (c, 4 * c), "b2": (c,)}
    for name, p in zip(shapes, (gamma, beta, w1, b1, w2, b2)):
        if tuple(p.shape) != shapes[name] or p.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {shapes[name]}, got {p.dtype} {tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError("x and the MLP's parameters must be on one device")
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(p.data_ptr() % 16 for p in (x, gamma, beta, w1, w2)):
        raise ValueError("x, gamma, beta, w1 and w2 must be 16-byte aligned (the kernel loads them 16 bytes at a time)")
    if not x.is_contiguous():
        raise ValueError("fused_mlp_residual takes a contiguous x")
    return x.numel() // c, c


_LAUNCH = _build.Launcher("fused_mlp", "rba_fused_mlp",
                          [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])


def takes(x: torch.Tensor) -> bool:
    """Whether a call runs the kernel: outside ``plain_versions()``, on any device but the
    CPU (the launcher raises on one other than CUDA, and on a shape it cannot take).
    Whether the MLP tail is fused at all is the Swin block's choice (``beneficial``)."""
    return x.device.type != "cpu" and not _PLAIN.get()


def fused_mlp_residual(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LayerNorm(x))))`` over the last axis: the hand kernel where
    ``takes`` says so (it raises on what it cannot take), else
    ``fused_mlp_residual_reference``."""
    if not takes(x):
        return fused_mlp_residual_reference(x, gamma, beta, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_residual runs on cuda or cpu, not {x.device}")
    t, c = _check(x, gamma, beta, w1, b1, w2, b2)
    if x.dtype == torch.bfloat16:  # the tensor-core kernel reads the weights in bf16
        w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    out = torch.empty_like(x)
    _LAUNCH(fused_mlp_residual, x.device, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), t, c, int(x.dtype == torch.bfloat16))
    return out


fused_mlp_residual.launches = 0  # kernel launches since the last reset
