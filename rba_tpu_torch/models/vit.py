"""ViTDet's plain ViT and its SimpleFeaturePyramid (counterpart of ``rba_tpu/models/vit.py``), NHWC.

A 16×16 patch embed, the absolute position table resized bicubic to the map, and
blocks of window or global attention with decomposed relative positions (the tables
resampled linearly to the sizes they meet), an MLP, and optionally a residual
bottleneck of convs.  It returns ``last_feat`` at stride 16.  ``sfp_apply`` turns it
into ``res2``…``res5`` at strides 4…32 with 2×2 transposed convs and a max pool.
LayerNorm eps 1e-6, with the variance centred (``ops.nn.centered_layer_norm``).  The
attention rounds as ``rba_tpu``'s does: q times the scale in the compute dtype, q·kᵀ and
the relative-position products in it, the two position terms added one after the other,
the softmax in fp32 rounded back, ``· v`` summed in fp32 and rounded; on the card Kernel H
computes that core in one launch where its ``takes`` says so.  Parameter names
follow the JAX pytree: ``blocks.3.attn.rel_pos_h``, ``pos_embed``,
``stages.0.up1_norm``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import rel_pos_attention as rel_pos_kernel
from ..ops.nn import apply_conv, apply_linear, centered_layer_norm, max_pool_nhwc
from ..ops.resize import interp_coeffs, resize_bicubic_nhwc
from ..utils.profiling import REL_POS_ATTENTION, span
from .swin import gelu


@dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    window_size: int = 14
    window_block_indexes: Tuple[int, ...] = (0, 1, 3, 4, 6, 7, 9, 10)
    residual_block_indexes: Tuple[int, ...] = ()
    pretrain_img_size: int = 224
    pretrain_use_cls_token: bool = True
    ln_eps: float = 1e-6


@functools.lru_cache(maxsize=None)
def _rel_pos_coeffs(table: int, q_size: int, k_size: int):
    """On the host: the resampling's (lo, hi, frac) to 2·max(q, k) − 1 entries (None at the
    table's own size) and the (q, k) gather index."""
    max_rel = 2 * max(q_size, k_size) - 1
    resample = interp_coeffs(table, max_rel, False) if table != max_rel else None
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return resample, ((q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _rel_pos_constants(table: int, q_size: int, k_size: int, device: torch.device):
    """``_rel_pos_coeffs`` copied to ``device`` once.  Kept for good: a CUDA graph captured
    over the gathers (``mvit_apply``) reads them at every replay."""
    with torch.inference_mode(False):
        resample, rel = _rel_pos_coeffs(table, q_size, k_size)
        if resample is not None:
            lo, hi, frac = resample
            resample = (torch.as_tensor(lo, device=device), torch.as_tensor(hi, device=device),
                        torch.as_tensor(frac, device=device)[:, None])
        return resample, torch.as_tensor(rel, device=device)


def rel_pos_resampled(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """ViTDet's ``get_rel_pos``: the (L, hd) table resampled linearly to 2·max(q, k) − 1
    entries in its dtype, then gathered at the scaled relative coordinates → (q, k, hd)."""
    resample, index = _rel_pos_constants(rel_pos.shape[0], q_size, k_size, rel_pos.device)
    if resample is not None:
        lo, hi, frac = resample
        rel_pos = rel_pos[lo] * (1 - frac) + rel_pos[hi] * frac
    return rel_pos[index]


@functools.lru_cache(maxsize=None)
def _rel_pos_tables_constants(tables: Tuple[int, int], q_hw: Tuple[int, int], kv_hw: Tuple[int, int],
                              device: torch.device):
    """``rel_pos_tables``' constants, copied to ``device`` once and kept for good, as
    ``_rel_pos_constants``: the rows of the stacked (R_h; R_w) that each entry's low taps,
    then its high taps, take (R_h's entries gathered at its (q_h, k_h) index, R_w's in
    order; a table not resampled takes its own row twice), as int64, their weights
    1 − frac and frac, flat, and R_w's (q_w, k_w) index as int32."""
    with torch.inference_mode(False):
        taps = []
        for axis in (0, 1):
            resample, rel = _rel_pos_coeffs(tables[axis], q_hw[axis], kv_hw[axis])
            n = 2 * max(q_hw[axis], kv_hw[axis]) - 1
            lo, hi, frac = resample if resample is not None else (np.arange(n), np.arange(n), np.zeros(n, np.float32))
            entries = rel.reshape(-1) if axis == 0 else np.arange(n)
            offset = axis * tables[0]
            taps.append((lo[entries] + offset, hi[entries] + offset, frac[entries]))
        rows = np.concatenate([taps[0][0], taps[1][0], taps[0][1], taps[1][1]])
        frac = np.concatenate([taps[0][2], taps[1][2]])
        weights = np.concatenate([np.float32(1) - frac, frac])
        _, index_w = _rel_pos_coeffs(tables[1], q_hw[1], kv_hw[1])
        return (torch.as_tensor(rows.astype(np.int64), device=device), torch.as_tensor(weights, device=device),
                torch.as_tensor(index_w.astype(np.int32), device=device))


def rel_pos_tables(rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
                   kv_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel H's position tables, both in one launch of ``kernels/rel_pos_attention.py``
    ``rel_pos_tables``: R_h resampled and gathered → (q_h, k_h, hd) and R_w resampled →
    (2·max(q_w, k_w) − 1, hd), both bf16, and R_w's (q_w, k_w) int32 index, which grows
    with the query's position and falls with the key's.  For finite tables each value is
    ``rel_pos_resampled``'s, cast, bit for bit: an entry's two taps times their weights,
    each product rounded, then their sum (a table not resampled: its row times 1 plus its
    row times 0)."""
    rows, weights, index_w = _rel_pos_tables_constants((rel_pos_h.shape[0], rel_pos_w.shape[0]), tuple(q_hw),
                                                       tuple(kv_hw), rel_pos_h.device)
    both = rel_pos_kernel.rel_pos_tables(rel_pos_h.float(), rel_pos_w.float(), rows, weights)
    n_h = q_hw[0] * kv_hw[0]
    return both[:n_h].view(q_hw[0], kv_hw[0], -1), both[n_h:], index_w


def scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x times ``scale`` rounded to x's dtype first, as JAX rounds a Python scalar."""
    return x * torch.tensor(scale, dtype=x.dtype).item()


def attention_core(
    q: torch.Tensor,  # (B·heads, q_h·q_w, hd), compute dtype
    k: torch.Tensor,  # (B·heads, k_h·k_w, hd)
    v: torch.Tensor,
    q_hw: Tuple[int, int],
    kv_hw: Tuple[int, int],
    rel_pos_h=None,
    rel_pos_w=None,
) -> torch.Tensor:  # (B·heads, q_h·q_w, hd), compute dtype
    """The ViT and MViT attention core, one ``rel_pos_attention`` span: Kernel H
    (``kernels/rel_pos_attention.py``) where its ``takes`` says so, the position tables
    made by ``rel_pos_tables`` (R_h gathered, R_w with its index), else the plain chain
    ``rel_pos_attention_plain``."""
    with span(REL_POS_ATTENTION):
        tables = rel_pos_h is not None
        needs_grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, rel_pos_h, rel_pos_w))
        if rel_pos_kernel.takes(q.device, q.dtype, needs_grad, q.shape[-1], tables, q.shape[0], kv_hw):
            rh, rw, rw_index = rel_pos_tables(rel_pos_h, rel_pos_w, q_hw, kv_hw)
            k, v = (rel_pos_kernel.readable(t) for t in (k, v))
            return rel_pos_kernel.rel_pos_attention(q, k, v, rh, rw, rw_index, q_hw, kv_hw)
        return rel_pos_attention_plain(q, k, v, q_hw, kv_hw, rel_pos_h, rel_pos_w)


def rel_pos_attention_plain(
    q: torch.Tensor,  # (B·heads, q_h·q_w, hd), compute dtype
    k: torch.Tensor,  # (B·heads, k_h·k_w, hd)
    v: torch.Tensor,
    q_hw: Tuple[int, int],
    kv_hw: Tuple[int, int],
    rel_pos_h=None,
    rel_pos_w=None,
) -> torch.Tensor:  # (B·heads, q_h·q_w, hd), compute dtype
    """The core in plain PyTorch: (q·scale)·kᵀ in the compute dtype, plus the decomposed
    relative positions (tables resampled in fp32, then cast), the softmax in fp32
    rounded back, and ``· v`` summed in fp32 and rounded."""
    dt = q.dtype
    attn = torch.matmul(scaled(q, q.shape[-1] ** -0.5), k.transpose(-1, -2))
    if rel_pos_h is not None:
        rh = rel_pos_resampled(rel_pos_h, q_hw[0], kv_hw[0]).to(dt)  # (q_h, k_h, hd)
        rw = rel_pos_resampled(rel_pos_w, q_hw[1], kv_hw[1]).to(dt)
        r_q = q.reshape(-1, q_hw[0], q_hw[1], q.shape[-1])
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = attn.reshape(-1, q_hw[0], q_hw[1], kv_hw[0], kv_hw[1])
        attn = (attn + rel_h[:, :, :, :, None]) + rel_w[:, :, :, None, :]
        attn = attn.reshape(-1, q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1])
    p = torch.softmax(attn.float(), dim=-1).to(dt)
    return torch.matmul(p, v)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, size: int, residual: bool):
        super().__init__()
        d, eps, hd = cfg.embed_dim, cfg.ln_eps, cfg.embed_dim // cfg.num_heads
        hidden = int(d * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.attn.proj = nn.Linear(d, d)
        if cfg.use_rel_pos:
            self.attn.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
            self.attn.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, hidden), "fc2": nn.Linear(hidden, d)})
        if residual:
            self.residual = nn.ModuleDict({
                "conv1": nn.Conv2d(d, d // 2, 1, bias=False), "norm1": nn.LayerNorm(d // 2, eps=eps),
                "conv2": nn.Conv2d(d // 2, d // 2, 3, bias=False), "norm2": nn.LayerNorm(d // 2, eps=eps),
                "conv3": nn.Conv2d(d // 2, d, 1, bias=False), "norm3": nn.LayerNorm(d, eps=eps),
            })


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.out_strides = {"last_feat": cfg.patch_size}
        self.out_channels = {"last_feat": cfg.embed_dim}
        self.patch_embed = nn.ModuleDict({"proj": nn.Conv2d(3, cfg.embed_dim, cfg.patch_size)})
        if cfg.use_abs_pos:
            n = cfg.pretrain_img_size // cfg.patch_size
            self.pos_embed = nn.Parameter(torch.zeros(1, n * n + int(cfg.pretrain_use_cls_token), cfg.embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, cfg.window_size if i in cfg.window_block_indexes else cfg.pretrain_img_size // cfg.patch_size,
                     i in cfg.residual_block_indexes)
            for i in range(cfg.depth)
        )


def _attention(attn: nn.Module, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, h, w, c = x.shape
    n, hd = h * w, c // num_heads
    qkv = apply_linear(attn.qkv, x).reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.reshape(b * num_heads, n, hd) for t in qkv)
    rel = (attn.rel_pos_h, attn.rel_pos_w) if hasattr(attn, "rel_pos_h") else (None, None)
    out = attention_core(q, k, v, (h, w), (h, w), *rel)
    out = out.reshape(b, num_heads, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
    return apply_linear(attn.proj, out)


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) zero-padded to multiples of ``ws`` → (B·nW, ws, ws, C), (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(xw: torch.Tensor, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    b = xw.shape[0] // ((hp // ws) * (wp // ws))
    x = xw.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, : hw[0], : hw[1]]


def _block_apply(blk: ViTBlock, x: torch.Tensor, cfg: ViTConfig, window_size: int) -> torch.Tensor:
    shortcut = x
    x = centered_layer_norm(x, blk.norm1)
    h, w = x.shape[1], x.shape[2]
    if window_size > 0:
        x, pad_hw = window_partition(x, window_size)
    x = _attention(blk.attn, x, cfg.num_heads)
    if window_size > 0:
        x = window_unpartition(x, window_size, pad_hw, (h, w))
    x = shortcut + x
    y = centered_layer_norm(x, blk.norm2)
    x = x + apply_linear(blk.mlp["fc2"], gelu(apply_linear(blk.mlp["fc1"], y)))
    if hasattr(blk, "residual"):
        r = blk.residual
        z = gelu(centered_layer_norm(apply_conv(r["conv1"], x), r["norm1"]))
        z = gelu(centered_layer_norm(apply_conv(r["conv2"], z, padding=1), r["norm2"]))
        x = x + centered_layer_norm(apply_conv(r["conv3"], z), r["norm3"])
    return x


def abs_pos_embed(table: torch.Tensor, hw: Tuple[int, int], has_cls_token: bool) -> torch.Tensor:
    """The (1, tokens, C) position table without its class token, as (1, n, n, C), resized
    bicubic to ``hw`` where it differs (``get_abs_pos``)."""
    pe = table[:, 1:] if has_cls_token else table
    n = int(math.sqrt(pe.shape[1]))
    return resize_bicubic_nhwc(pe.reshape(1, n, n, -1), hw)


def vit_apply(model: ViT, images: torch.Tensor, compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) normalized → {"last_feat": (B, H/16, W/16, C)} in ``compute_dtype``."""
    cfg = model.cfg
    x = apply_conv(model.patch_embed["proj"], images.to(compute_dtype), stride=cfg.patch_size, padding="VALID")
    if cfg.use_abs_pos:
        x = x + abs_pos_embed(model.pos_embed, (x.shape[1], x.shape[2]), cfg.pretrain_use_cls_token).to(compute_dtype)
    for i, blk in enumerate(model.blocks):
        x = _block_apply(blk, x, cfg, cfg.window_size if i in cfg.window_block_indexes else 0)
    return {"last_feat": x}


# ---------------------------------------------------------------------------
# SimpleFeaturePyramid
# ---------------------------------------------------------------------------

SFP_NAMES = {4.0: "res2", 2.0: "res3", 1.0: "res4", 0.5: "res5"}


class SFPStage(nn.Module):
    """One scale of the pyramid.  The 2×2 transposed convs keep the JAX package's HWIO
    kernel (in, out) as an OIHW weight of shape (out, in, 2, 2)."""

    def __init__(self, scale: float, dim: int, out_channels: int, eps: float = 1e-6):
        super().__init__()
        self.scale = scale
        out_dim = dim
        if scale == 4.0:
            self.up1, self.up1_norm = nn.Conv2d(dim, dim // 2, 2), nn.LayerNorm(dim // 2, eps=eps)
            self.up2 = nn.Conv2d(dim // 2, dim // 4, 2)
            out_dim = dim // 4
        elif scale == 2.0:
            self.up1 = nn.Conv2d(dim, dim // 2, 2)
            out_dim = dim // 2
        elif scale not in (1.0, 0.5):
            raise NotImplementedError(f"SimpleFeaturePyramid scale {scale}")
        self.lateral = nn.ModuleDict({"conv": nn.Conv2d(out_dim, out_channels, 1, bias=False),
                                      "norm": nn.LayerNorm(out_channels, eps=eps)})
        self.output = nn.ModuleDict({"conv": nn.Conv2d(out_channels, out_channels, 3, bias=False),
                                     "norm": nn.LayerNorm(out_channels, eps=eps)})


class SimpleFeaturePyramid(nn.Module):
    def __init__(self, dim: int, out_channels: int = 256, scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)):
        super().__init__()
        self.stages = nn.ModuleList(SFPStage(s, dim, out_channels) for s in scale_factors)

    def jax_constants(self) -> Dict:
        """The numbers that the JAX package's tree keeps beside the weights."""
        return {"stages": [{"scale": st.scale} for st in self.stages]}


def conv_transpose2x(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``lax.conv_transpose`` of (N, H, W, C) with stride 2 and a 2×2 kernel, "VALID":
    out[2i + a, 2j + b] = Σ_c x[i, j, c]·K[1 − a, 1 − b, c] (the kernel is not flipped,
    unlike torch's transposed conv), plus the bias, in x's dtype."""
    w = conv.weight.to(x.dtype).flip(2, 3).transpose(0, 1)  # (in, out, 2, 2) for conv_transpose2d
    fused = x.dtype == torch.float32
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, conv.bias.to(x.dtype) if fused else None, stride=2)
    y = y.permute(0, 2, 3, 1)
    return y if fused else y + conv.bias.to(x.dtype)


def sfp_apply(model: SimpleFeaturePyramid, features: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``last_feat`` (stride 16) → {res2..res5} at strides 4, 8, 16, 32."""
    outs = {}
    for st in model.stages:
        x = features
        if st.scale == 4.0:
            x = conv_transpose2x(st.up2, gelu(centered_layer_norm(conv_transpose2x(st.up1, x), st.up1_norm)))
        elif st.scale == 2.0:
            x = conv_transpose2x(st.up1, x)
        elif st.scale == 0.5:
            x = max_pool_nhwc(x, 2, 2)
        x = centered_layer_norm(apply_conv(st.lateral["conv"], x), st.lateral["norm"])
        outs[SFP_NAMES[st.scale]] = centered_layer_norm(apply_conv(st.output["conv"], x, padding=1), st.output["norm"])
    return outs
