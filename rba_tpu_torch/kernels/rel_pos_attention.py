"""The attention core with decomposed relative positions (ViTDet, MViTv2) on the card: the
hand kernel ``csrc/rel_pos_attention.cu`` (Kernel H).

It replaces no Pallas kernel: ``rba_tpu`` computes the core in plain jnp, which XLA
fuses, while eager PyTorch runs the port's chain (``models/vit.py``
``rel_pos_attention_plain``) as ten to twelve operations that write each call's score
matrix to device memory and read it back several times.  The kernel computes that
chain, with its roundings, position products included, in one launch per call, reading
q by its strides, k and v by their rows' strides, and the resampled position tables as
they are: R_h gathered to (q_h, k_h, hd), R_w before its gather, with the gather's index.
A second, small kernel in the same source (``rel_pos_tables``) makes those tables from
the fp32 parameters in one launch.
``models/vit.py`` runs the one ``takes`` names: the plain chain stays for the CPU, for
fp32, for training (the kernel has no gradient), for head dims the kernel is not built
for and for a call without position tables.  The source note in the .cu file gives the
bound and the design.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _PLAIN, _build

HEAD_DIMS = (64, 96)  # per-head channels the kernel is built for: 64 on ViTDet-B, 96 on MViTv2-B
MAX_CALLS = 65535  # windows x images x heads: the launch's second grid dimension
MAX_TABLE = 400  # kw + 2 kh, kw rounded up to even: each query row's position terms, in bf16, in shared memory
# hd**-0.5 rounded to bf16, as models/vit.py scaled rounds it
SCALES = {hd: torch.tensor(hd**-0.5, dtype=torch.bfloat16).item() for hd in HEAD_DIMS}


def fits(calls: int, kv_hw: Tuple[int, int]) -> bool:
    """Whether a call's sizes are within the kernel's: at most ``MAX_CALLS`` windows x
    images x heads, and each query row's position terms (``MAX_TABLE``) in shared memory."""
    kh, kw = kv_hw
    return 1 <= calls <= MAX_CALLS and kw + kw % 2 + 2 * kh <= MAX_TABLE


def takes(device: torch.device, dtype: torch.dtype, needs_grad: bool, head_dim: int, tables: bool = True,
          calls: int = 1, kv_hw: Tuple[int, int] = (1, 1)) -> bool:
    """Whether an attention core runs the kernel: outside ``plain_versions()``, its tensors
    are on CUDA in bf16, autograd does not need the core's gradient, the kernel is built
    for the head dim (``HEAD_DIMS``), the call has its position tables and its sizes
    ``fits``."""
    return (device.type == "cuda" and dtype == torch.bfloat16 and not needs_grad and head_dim in HEAD_DIMS
            and tables and fits(calls, kv_hw) and not _PLAIN.get())


def _check(q, k, v, rel_h, rel_w, rel_w_index, q_hw, kv_hw) -> Tuple[int, int]:
    """(calls, head dim) of a call the kernel takes; raises on any other."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or rel_h.dim() != 3 or rel_w.dim() != 2:
        raise ValueError(f"q, k and v must be (calls, tokens, hd), rel_h (q, k, hd) and rel_w (entries, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(rel_h.shape)} and "
                         f"{tuple(rel_w.shape)}")
    (qh, qw), (kh, kw) = q_hw, kv_hw
    calls, nq, hd = q.shape
    if (min(calls, qh, qw, kh, kw, rel_w.shape[0]) < 1 or nq != qh * qw or k.shape != (calls, kh * kw, hd)
            or v.shape != k.shape or rel_h.shape != (qh, kh, hd) or rel_w.shape[1] != hd
            or rel_w_index.shape != (qw, kw)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, rel_h {tuple(rel_h.shape)}, "
                         f"rel_w {tuple(rel_w.shape)} and rel_w_index {tuple(rel_w_index.shape)} do not match q_hw "
                         f"{q_hw} and kv_hw {kv_hw}")
    if rel_w_index.dtype != torch.int32 or not rel_w_index.is_contiguous():
        raise TypeError(f"rel_w_index must be a contiguous int32 tensor, got {rel_w_index.dtype}")
    if hd not in HEAD_DIMS or not fits(calls, kv_hw):
        raise ValueError(f"the attention kernel takes head dims {HEAD_DIMS}, at most {MAX_CALLS} calls and "
                         f"kw + 2 kh <= {MAX_TABLE}, got head dim {hd}, {calls} calls and kv_hw {kv_hw}")
    for name, x in (("q", q), ("k", k), ("v", v), ("rel_h", rel_h), ("rel_w", rel_w)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernel takes bfloat16 {name}, got {x.dtype}")
        if name == "q":
            continue  # read by its strides, whatever they are
        dense = x.is_contiguous() if name.startswith("rel") else (
            x.stride(2) == 1 and not any(n > 1 and st % 8 for n, st in zip(x.shape[:2], x.stride()[:2])))
        if not dense or x.data_ptr() % 16:
            raise ValueError(f"the attention kernel reads rows of {name} as 16-byte words: its rows must be dense "
                             "(the tables contiguous) and start on 16 bytes")
    return calls, hd


def readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` (k or v) where the kernel can read its rows as 16-byte words (the last dim
    dense, the other strides and the start on 16 bytes), else a compact copy of it."""
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and not any(
            n > 1 and st % 8 for n, st in zip(x.shape[:-1], x.stride()[:-1])):
        return x
    return x.clone(memory_format=torch.contiguous_format)


_LAUNCH = _build.Launcher("rel_pos_attention", "rba_rel_pos_attention",
                          [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 7 + [ctypes.c_float])
_TABLES = _build.Launcher("rel_pos_attention", "rba_rel_pos_tables",
                          [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def rel_pos_attention(
    q: torch.Tensor,  # (calls, q_h·q_w, hd) bf16
    k: torch.Tensor,  # (calls, k_h·k_w, hd) bf16
    v: torch.Tensor,  # (calls, k_h·k_w, hd) bf16
    rel_h: torch.Tensor,  # (q_h, k_h, hd) bf16: R_h resampled and gathered
    rel_w: torch.Tensor,  # (entries, hd) bf16: R_w resampled, before its gather
    rel_w_index: torch.Tensor,  # (q_w, k_w) int32: the entry of rel_w that each (i_w, j_w) takes
    q_hw: Tuple[int, int],
    kv_hw: Tuple[int, int],
) -> torch.Tensor:  # (calls, q_h·q_w, hd) bf16
    """softmax((q·bf16(hd^-0.5))·kᵀ + rel_h + rel_w[rel_w_index])·v per call, the position
    terms the products of the unscaled q with the tables, rounded as
    ``rel_pos_attention_plain`` rounds it, in one launch.  ``rel_w_index`` is
    ``models/vit.py`` ``rel_pos_tables``': its entries lie in ``rel_w``, grow with i_w and
    fall with j_w.  Checks the arguments first, then launches on their CUDA device or
    raises: it has no plain fallback and no gradient."""
    calls, hd = _check(q, k, v, rel_h, rel_w, rel_w_index, q_hw, kv_hw)
    device = q.device
    if device.type != "cuda" or any(x.device != device for x in (k, v, rel_h, rel_w, rel_w_index)):
        raise ValueError(f"rel_pos_attention runs on one cuda device, got {[str(x.device) for x in (q, k, v)]} "
                         f"and tables on {rel_h.device}, {rel_w.device}")
    _build.refuse_grad("rel_pos_attention", q, k, v, rel_h, rel_w)
    out = torch.empty(q.shape, dtype=q.dtype, device=device)
    _LAUNCH(rel_pos_attention, device, q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            rel_w_index.data_ptr(), out.data_ptr(), calls, *q_hw, *kv_hw, hd, *q.stride(), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), SCALES[hd])
    return out


rel_pos_attention.launches = 0  # kernel launches since the last reset


def rel_pos_tables(
    rel_pos_h: torch.Tensor,  # (len_h, hd) fp32: R_h's parameter
    rel_pos_w: torch.Tensor,  # (len_w, hd) fp32: R_w's parameter
    rows: torch.Tensor,  # (2 n,) int64: each entry's low taps, then its high taps, rows of (R_h; R_w)
    weights: torch.Tensor,  # (2 n,) fp32: the taps' weights
) -> torch.Tensor:  # (n, hd) bf16
    """Entry e of the stacked tables is bf16(R[rows[e]]·weights[e] + R[rows[n + e]]·weights[n + e])
    with R the rows of ``rel_pos_h`` then ``rel_pos_w``, each product rounded to fp32
    before the sum, in one launch: ``models/vit.py`` ``rel_pos_tables`` hands it the rows
    and weights that make ``rel_pos_resampled``'s tables, cast.  Checks the arguments
    first, then launches on their CUDA device or raises."""
    if rel_pos_h.dim() != 2 or rel_pos_w.dim() != 2 or rel_pos_w.shape[1] != rel_pos_h.shape[1]:
        raise ValueError(f"the tables take (entries, hd) parameters of one hd, got {tuple(rel_pos_h.shape)} and "
                         f"{tuple(rel_pos_w.shape)}")
    n2 = rows.shape[0] if rows.dim() == 1 else -1
    if n2 < 2 or n2 % 2 or weights.shape != (n2,):
        raise ValueError(f"rows and weights must be (2 n,), got {tuple(rows.shape)} and {tuple(weights.shape)}")
    for name, x, dtype in (("rel_pos_h", rel_pos_h, torch.float32), ("rel_pos_w", rel_pos_w, torch.float32),
                           ("rows", rows, torch.int64), ("weights", weights, torch.float32)):
        if x.dtype != dtype or not x.is_contiguous():
            raise TypeError(f"the tables take a contiguous {dtype} {name}, got {x.dtype}")
    device = rel_pos_h.device
    if device.type != "cuda" or any(x.device != device for x in (rel_pos_w, rows, weights)):
        raise ValueError(f"rel_pos_tables runs on one cuda device, got {[str(x.device) for x in (rel_pos_h, rows)]}")
    _build.refuse_grad("rel_pos_tables", rel_pos_h, rel_pos_w)
    hd = rel_pos_h.shape[1]
    out = torch.empty(n2 // 2, hd, dtype=torch.bfloat16, device=device)
    _TABLES(rel_pos_tables, device, rel_pos_h.data_ptr(), rel_pos_w.data_ptr(), rel_pos_h.shape[0], rows.data_ptr(),
            weights.data_ptr(), n2 // 2, hd, out.data_ptr())
    return out


rel_pos_tables.launches = 0  # kernel launches since the last reset
