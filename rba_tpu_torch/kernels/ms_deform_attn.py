"""Multi-scale deformable attention sampling, forward: the hand kernel
``csrc/ms_deform_attn.cu`` (Kernel F).

It replaces no Pallas kernel: ``rba_tpu`` samples with a jnp gather, which XLA fuses,
while eager PyTorch runs the port's gather (``ops/deform_sampling.py`` ``_sample_level``)
as about 100 small operations per level.  The kernel computes that gather, summed over
levels, points and corners, in one launch per call, and writes the (N, Lq, M·D) output
directly.  Its plain version is ``ops/deform_sampling.py`` ``ms_deform_attn_plain``, and
``ms_deform_attn_core`` there runs the one ``takes`` names: the plain version stays for
the CPU, for training (the kernel has no gradient), for the bf16 one-hot form and for
shapes the kernel is not built for (``supports``).  The source note in the .cu file
gives the bound and the design.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _PLAIN, _build

HEAD_DIMS = (16, 32)  # per-head channels D the kernel is built for: 32 in every served config, 16 in the tests
MAX_LEVELS = 4
WARPS = 8  # warps per block of the launch (kWarps in the .cu), one per (batch, query, head)


def supports(value_shape: Sequence[int], loc_shape: Sequence[int]) -> bool:
    """Whether the kernel is built for a call of these shapes, value (N, S, M, D) and
    sampling_locations (N, Lq, M, L, P, 2): D in ``HEAD_DIMS``, 1 to ``MAX_LEVELS``
    levels, and sizes that the launch's 32-bit arguments hold."""
    n, s, m, d = value_shape
    lq, nl, p = loc_shape[1], loc_shape[3], loc_shape[4]
    return (d in HEAD_DIMS and 1 <= nl <= MAX_LEVELS
            and max(s, lq, 4 * nl * p, -(-n * lq * m // WARPS)) < 2**31)


def takes(device: torch.device, needs_grad: bool, methods: Sequence[str], sampling_dtype: str,
          value_shape: Sequence[int], loc_shape: Sequence[int]) -> bool:
    """Whether a call runs the kernel: outside ``plain_versions()``, its tensors are on
    CUDA, autograd does not need the sampling's gradient, no level takes the one-hot form
    (``"onehot"`` in ``methods`` at ``sampling_dtype="bfloat16"``), and the kernel is built
    for its shapes, value (N, S, M, D) and sampling_locations (N, Lq, M, L, P, 2)
    (``supports``: D 16 or 32, 1 to 4 levels)."""
    onehot = sampling_dtype == "bfloat16" and "onehot" in methods
    return (device.type == "cuda" and not needs_grad and not onehot and supports(value_shape, loc_shape)
            and not _PLAIN.get())


def _check(value, spatial_shapes, loc, attn) -> Tuple[int, int, int, int, int, int, int]:
    """(N, S, M, D, Lq, L, P) of a call the kernel takes; raises on any other."""
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError(f"value must be (N, S, M, D), sampling_locations (N, Lq, M, L, P, 2) and "
                         f"attention_weights (N, Lq, M, L, P), got {tuple(value.shape)}, {tuple(loc.shape)}, "
                         f"{tuple(attn.shape)}")
    n, s, m, d = value.shape
    _, lq, _, nl, p, _ = loc.shape
    if loc.shape[:3] != (n, lq, m) or loc.shape[-1] != 2 or tuple(attn.shape) != (n, lq, m, nl, p):
        raise ValueError(f"sampling_locations {tuple(loc.shape)} and attention_weights {tuple(attn.shape)} "
                         f"do not match value {tuple(value.shape)}")
    if min(n, s, m, lq, p) < 1:
        raise ValueError(f"empty call: value {tuple(value.shape)}, sampling_locations {tuple(loc.shape)}")
    if not supports(value.shape, loc.shape):
        raise ValueError(f"the sampling kernel takes D in {HEAD_DIMS} channels per head, 1 to {MAX_LEVELS} levels "
                         f"and sizes below 2**31, got value {tuple(value.shape)} and sampling_locations "
                         f"{tuple(loc.shape)}")
    if len(spatial_shapes) != nl or sum(h * w for h, w in spatial_shapes) != s \
            or min(min(hw) for hw in spatial_shapes) < 1:
        raise ValueError(f"spatial shapes {list(spatial_shapes)} do not tile S = {s} in {nl} levels")
    for name, x in (("value", value), ("sampling_locations", loc), ("attention_weights", attn)):
        if x.dtype != torch.float32:
            raise TypeError(f"the sampling kernel takes float32 {name}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the sampling kernel takes a contiguous {name}")
    if value.data_ptr() % 16 or loc.data_ptr() % 8:
        raise ValueError("the sampling kernel reads value rows as 16-byte and locations as 8-byte words: "
                         "value must start on 16 bytes and sampling_locations on 8")
    return n, s, m, d, lq, nl, p


_LAUNCH = _build.Launcher("ms_deform_attn", "rba_ms_deform_attn", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                          + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2)


def ms_deform_attn(
    value: torch.Tensor,  # (N, S, M, D) fp32
    spatial_shapes: Sequence[Tuple[int, int]],  # (H, W) per level, Python ints
    sampling_locations: torch.Tensor,  # (N, Lq, M, L, P, 2) fp32
    attention_weights: torch.Tensor,  # (N, Lq, M, L, P) fp32
) -> torch.Tensor:  # (N, Lq, M·D) fp32
    """The deformable sampling's gather form on the card, in one launch.  Checks the
    arguments first, then launches on their CUDA device or raises: it has no plain
    fallback and no gradient."""
    n, s, m, d, lq, nl, p = _check(value, spatial_shapes, sampling_locations, attention_weights)
    device = value.device
    if device.type != "cuda" or sampling_locations.device != device or attention_weights.device != device:
        raise ValueError(f"ms_deform_attn runs on one cuda device, got {device}, {sampling_locations.device} "
                         f"and {attention_weights.device}")
    _build.refuse_grad("ms_deform_attn", value, sampling_locations, attention_weights)
    out = torch.empty(n, lq, m * d, dtype=torch.float32, device=device)
    hw = (ctypes.c_int * (2 * nl))(*(int(x) for shape in spatial_shapes for x in shape))
    _LAUNCH(ms_deform_attn, device, value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
            out.data_ptr(), n, s, m, d, lq, hw, nl, p)
    return out


ms_deform_attn.launches = 0  # kernel launches since the last reset
