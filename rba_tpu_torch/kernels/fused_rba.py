"""Fused RbA score: the hand kernel ``csrc/fused_rba.cu`` and its plain version.

Replaces ``rba_tpu/ops/pallas/fused_rba.py`` ``fused_rba_score``: x4 bilinear
upsample of the low-res mask logits, sigmoid, contraction over the queries with
``softmax(cls)[..., :K]`` and ``-Σ_K tanh``, without the (Q, 4h, 4w) tensor.
The softmax over the (B, Q, K+1) class logits is a small PyTorch prologue; the
kernel does the rest: persistent blocks stage the low-res rows of a tile in
shared memory, each 4x4 output patch blends its four low-res pixels, and the
class contraction runs on the tensor cores as three TF32 products of split
operands, which keeps fp32 accuracy.  The source note in the .cu file gives the
bound and the design.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _PLAIN, _build

SMEM_LIMIT = 227 * 1024  # shared memory one block can have on the H100
_TILE_COLS = 33  # low-res pixels per staged row (csrc/fused_rba.cu kTileCols)
_PASS_CLASSES = 24  # classes per pass over the queries (8 * kPassTiles)


def smem_bytes(q: int, k: int) -> int:
    """Shared memory the kernel needs for Q queries and K classes: cls split into two
    TF32 terms in fragment order, and two staging buffers of 2 low-res rows."""
    qp = -(-q // 8) * 8
    kp = -(-k // _PASS_CLASSES) * _PASS_CLASSES
    return 4 * (qp * kp * 2 + 4 * _TILE_COLS * qp)


def _bqhw(mask_pred: torch.Tensor, masks_layout: str) -> torch.Tensor:
    if masks_layout == "bqhw":
        return mask_pred
    if masks_layout == "bhwq":
        return mask_pred.permute(0, 3, 1, 2)
    raise ValueError(f"masks_layout {masks_layout!r}")


def fused_rba_score_reference(
    mask_cls: torch.Tensor,  # (B, Q, K+1) class logits
    mask_pred: torch.Tensor,  # (B, Q, h, w) or (B, h, w, Q) mask logits
    masks_layout: str = "bqhw",
) -> torch.Tensor:  # (B, 4h, 4w) fp32
    """Plain PyTorch version: it materializes the upsampled (B, Q, 4h, 4w) masks."""
    m = _bqhw(mask_pred, masks_layout).float()
    h, w = m.shape[-2:]
    up = F.interpolate(m, size=(4 * h, 4 * w), mode="bilinear", align_corners=False)
    cls = torch.softmax(mask_cls.float(), dim=-1)[..., :-1]
    sem = torch.einsum("bqk,bqhw->bkhw", cls, torch.sigmoid(up))
    return -torch.tanh(sem).sum(dim=1)


_LAUNCH = _build.Launcher("fused_rba", "rba_fused_rba_score", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5)


def takes(mask_pred: torch.Tensor) -> bool:
    """Whether a call runs the kernel: outside ``plain_versions()``, on any device but the
    CPU (the launcher raises on one other than CUDA, and on a shape it cannot take)."""
    return mask_pred.device.type != "cpu" and not _PLAIN.get()


def fused_rba_score(
    mask_cls: torch.Tensor,
    mask_pred: torch.Tensor,
    masks_layout: str = "bqhw",
) -> torch.Tensor:  # (B, 4h, 4w) fp32
    """RbA score map of the x4-upsampled masks: the hand kernel where ``takes`` says so
    (it raises on what it cannot take; a ``bqhw`` input is transposed to ``bhwq``
    first), else ``fused_rba_score_reference``."""
    if not takes(mask_pred):
        return fused_rba_score_reference(mask_cls, mask_pred, masks_layout)
    if mask_pred.device.type != "cuda" or mask_cls.device != mask_pred.device:
        raise ValueError(f"fused_rba_score runs on one cuda device or on cpu, got "
                         f"{mask_cls.device} and {mask_pred.device}")
    if mask_pred.dim() != 4 or mask_cls.dim() != 3:
        raise ValueError("mask_cls must be (B, Q, K+1) and mask_pred 4-D")
    if mask_pred.dtype != torch.float32 or mask_cls.dtype != torch.float32:
        raise TypeError("fused_rba_score takes float32 logits")
    m = _bqhw(mask_pred, masks_layout).permute(0, 2, 3, 1)  # (B, h, w, Q)
    if masks_layout == "bqhw":
        m = m.contiguous()
    elif not m.is_contiguous():
        raise ValueError("bhwq masks must be contiguous")
    b, h, w, q = m.shape
    if tuple(mask_cls.shape[:2]) != (b, q) or mask_cls.shape[2] < 2:
        raise ValueError(f"mask_cls {tuple(mask_cls.shape)} does not match masks with B={b}, Q={q}")
    k = mask_cls.shape[2] - 1
    if smem_bytes(q, k) > SMEM_LIMIT:
        raise ValueError(f"Q = {q}, K = {k} need {smem_bytes(q, k)} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block can have")
    cls = torch.softmax(mask_cls, dim=-1)[..., :k].contiguous()
    out = torch.empty(b, 4 * h, 4 * w, dtype=torch.float32, device=m.device)
    _LAUNCH(fused_rba_score, m.device, cls.data_ptr(), m.data_ptr(), out.data_ptr(), b, q, k, h, w)
    return out


fused_rba_score.launches = 0  # kernel launches since the last reset
