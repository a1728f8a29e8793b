"""Swin transformer backbone (counterpart of ``rba_tpu/models/swin.py``), partition layout.

NHWC activations.  Parameter names follow the JAX pytree: ``layers.0.blocks.1.attn.qkv``
holds ``params["layers"][0]["blocks"][1]["attn"]["qkv"]``.  LayerNorm and the
attention softmax run in fp32 (the softmax in the compute dtype under ``fast_math``);
the matmuls in the compute dtype.

Window attention takes one of three branches, chosen by the caller's ``attention``
argument (the JAX package picks them with environment variables, which the port
does not read):

- ``"fused"``: ``kernels.window_attention`` (Kernel A), the counterpart of the
  ``RBA_TPU_FUSED_ATTENTION`` branch (``rba_tpu/models/swin.py:207-220``), which
  ``rba_tpu`` takes before it reads ``fast_math``;
- ``"fused_softmax"``: q·kᵀ in fp32 by ``torch.matmul``, then
  ``kernels.masked_softmax`` (Kernel C), then ``· v``; the counterpart of the
  ``RBA_TPU_FUSED_SOFTMAX`` branch (``rba_tpu/models/swin.py:256-284, 326-327``).
  ``rba_tpu`` ignores that branch under ``fast_math``, and so does the port: it then
  runs the bf16 softmax of the ``"xla"`` branch and launches no Kernel C;
- ``"xla"``: ``rba_tpu``'s default chain in plain PyTorch (``swin.py:236-330``):
  compute-dtype scores, the factorized fp32 softmax, or under ``fast_math`` the
  softmax in the compute dtype (``:285-295``).

With ``SwinConfig.mlp_impl == "fused"``, no gradient tracked and C where
``kernels.fused_mlp.beneficial`` holds, a block's MLP tail goes through
``kernels.fused_mlp`` (Kernel D), as ``rba_tpu/models/swin.py:488-501`` decides.  Under tensor parallelism
(``parallel/tp.py``) Kernel D reads the whole fc1 and fc2, gathered from their shards.

``SwinConfig.attn_layout`` "nested", "resident" and "qkv_canvas" are ``rba_tpu``'s TPU
lowerings of the partition layout's function ("identical math", ``rba_tpu/config.py:44-56``),
so every layout runs the partition layout here.  ``SwinConfig.use_checkpoint``
rematerialises each block under autograd (``torch.utils.checkpoint``), as ``rba_tpu``
wraps each block in ``jax.checkpoint`` (the reference in ``torch.utils.checkpoint``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..config import SwinConfig
from ..kernels.fused_mlp import beneficial, fused_mlp_residual
from ..kernels.masked_softmax import masked_softmax
from ..kernels.window_attention import window_attention
from ..ops.nn import apply_linear, apply_norm
from ..ops.resize import resize_bicubic_nhwc
from ..parallel.tp import full_linear

ATTENTION = ("fused", "fused_softmax", "xla")  # the window-attention branches


@functools.lru_cache(maxsize=64)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws-1)² relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=256)
def shifted_window_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) additive mask (0 / -100) of shifted-window attention."""
    img_mask = np.zeros((hp, wp), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, ws: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, ws: int, num_heads: int, mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(dim, hidden), "fc2": nn.Linear(hidden, dim)})


class SwinLayer(nn.Module):
    def __init__(self, cfg: SwinConfig, i: int):
        super().__init__()
        dim = cfg.stage_dim(i)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.window_size, cfg.num_heads[i], cfg.mlp_ratio, cfg.qkv_bias)
            for _ in range(cfg.depths[i])
        )
        if i < cfg.num_layers - 1:
            self.downsample = nn.ModuleDict(
                {"norm": nn.LayerNorm(4 * dim), "reduction": nn.Linear(4 * dim, 2 * dim, bias=False)}
            )
        else:
            self.downsample = None


class Swin(nn.Module):
    """Parameters of the Swin backbone; ``swin_apply`` runs it.  With ``ape`` it holds the
    (1, n, n, C) absolute position table of the pretraining size."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.out_channels = cfg.out_channels
        self.out_strides = {f"res{i + 2}": cfg.patch_size * 2**i for i in range(cfg.num_layers)}
        embed = nn.ModuleDict({"proj": nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)})
        if cfg.patch_norm:
            embed["norm"] = nn.LayerNorm(cfg.embed_dim)
        self.patch_embed = embed
        if cfg.ape:
            n = cfg.pretrain_img_size // cfg.patch_size
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, n, n, cfg.embed_dim))
        self.layers = nn.ModuleList(SwinLayer(cfg, i) for i in range(cfg.num_layers))
        for i in range(cfg.num_layers):
            if f"res{i + 2}" in cfg.out_features:
                self.add_module(f"norm{i}", nn.LayerNorm(cfg.stage_dim(i)))


@functools.lru_cache(maxsize=64)
def _device_constant(name: str, device: torch.device, *key) -> torch.Tensor:
    """The numpy constant ``name(*key)`` as a tensor on ``device``, copied there once.
    Made outside inference mode, so that the cached tensor also serves later calls
    that do track gradients."""
    fn = {"index": relative_position_index, "mask": shifted_window_mask}[name]
    with torch.inference_mode(False):
        return torch.as_tensor(fn(*key), device=device)


def _rel_bias(attn: WindowAttention, ws: int, nh: int) -> torch.Tensor:
    n = ws * ws
    idx = _device_constant("index", attn.relative_position_bias_table.device, ws).reshape(-1)
    bias = attn.relative_position_bias_table.float()[idx].reshape(n, n, nh)
    return bias.permute(2, 0, 1).contiguous()  # (nh, N, N)


def _split_heads(qkv: torch.Tensor, nh: int, scale: float):
    """q, k, v as (B·nW, nh, N, hd) from (B·nW, N, 3C), q times ``scale`` in qkv's dtype
    (the scale rounded to it first, as JAX rounds a Python scalar)."""
    bw, n, c3 = qkv.shape
    q, k, v = qkv.reshape(bw, n, 3, nh, c3 // (3 * nh)).permute(2, 0, 3, 1, 4)
    return q * torch.tensor(scale, dtype=qkv.dtype).item(), k, v


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    bw, nh, n, hd = out.shape
    return out.permute(0, 2, 1, 3).reshape(bw, n, nh * hd)


def _fast_softmax(s: torch.Tensor, rel_bias: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``rba_tpu``'s ``fast_math`` softmax (``swin.py:285-295``) in the scores' dtype:
    bias and mask added in it, then ``jax.nn.softmax``'s steps on it (max, subtract and
    exp in the dtype, the sum in fp32 rounded to the dtype, the divide in the dtype)."""
    dt = s.dtype
    a = s + rel_bias.to(dt)
    if mask is not None:
        nw, n = mask.shape[0], mask.shape[-1]
        a = (a.reshape(-1, nw, a.shape[1], n, n) + mask.to(dt)[None, :, None]).reshape(a.shape)
    e = torch.exp(a - a.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(dt)


def xla_attention(
    qkv: torch.Tensor,  # (B·nW, N, 3C)
    rel_bias: torch.Tensor,  # (nh, N, N) fp32
    mask: Optional[torch.Tensor],  # (nW, N, N) fp32 additive, or None
    nh: int,
    scale: float,
    fast_math: bool = False,
) -> torch.Tensor:  # (B·nW, N, C), qkv's dtype
    """The ``"xla"`` branch, ``rba_tpu``'s default chain: q·kᵀ rounded to the compute
    dtype; the factorized fp32 softmax exp(s − max s)·exp(b − max b)·keep / Σ with
    keep = (mask == 0), probabilities rounded to the compute dtype (under
    ``fast_math``, ``_fast_softmax``); then ``· v`` summed in fp32 and rounded."""
    q, k, v = _split_heads(qkv, nh, scale)
    s = torch.matmul(q, k.transpose(-1, -2))
    if fast_math:
        p = _fast_softmax(s, rel_bias, mask)
    else:
        s32 = s.float()
        eb = torch.exp(rel_bias - rel_bias.amax(dim=-1, keepdim=True))
        num = torch.exp(s32 - s32.amax(dim=-1, keepdim=True)) * eb
        if mask is not None:
            nw, n = mask.shape[0], mask.shape[-1]
            num = (num.reshape(-1, nw, nh, n, n) * (mask == 0).float()[None, :, None]).reshape(num.shape)
        p = (num / num.sum(dim=-1, keepdim=True)).to(qkv.dtype)
    return _merge_heads(torch.matmul(p, v))


def softmax_attention(
    qkv: torch.Tensor,  # (B·nW, N, 3C)
    rel_bias: torch.Tensor,  # (nh, N, N) fp32
    mask: Optional[torch.Tensor],  # (nW, N, N) fp32 additive, or None
    nh: int,
    scale: float,
    fast_math: bool = False,
) -> torch.Tensor:  # (B·nW, N, C), qkv's dtype
    """The ``"fused_softmax"`` branch: ``q * scale`` in the compute dtype, q·kᵀ into
    fp32, Kernel C (bias and mask added, fp32 softmax, probabilities in the compute
    dtype), then ``· v`` summed in fp32 and rounded to the compute dtype.  Under
    ``fast_math`` it is the ``"xla"`` branch's bf16 softmax chain and launches no
    Kernel C, as ``rba_tpu`` ignores its fused-softmax switch there."""
    if fast_math:
        return xla_attention(qkv, rel_bias, mask, nh, scale, fast_math=True)
    q, k, v = _split_heads(qkv, nh, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = masked_softmax(s, rel_bias, mask, qkv.dtype)
    return _merge_heads(torch.matmul(p.float(), v.float()).to(qkv.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``.  Below fp32 it takes the steps of its jaxpr,
    each rounded to x's dtype: 0.5·x times erfc((−x)·0.70703125), where (−x)·c is
    taken as x·(−c), the same rounding of the same product."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (x * 0.5) * torch.special.erfc(x * -0.70703125)


def _mlp_tail(blk: SwinBlock, x: torch.Tensor, mlp_impl: str) -> torch.Tensor:
    """``x + fc2(gelu(fc1(norm2(x))))``: Kernel D where ``rba_tpu``'s dispatch would take
    the Pallas kernel (``mlp_impl="fused"``, inference, ``beneficial``), else the unfused
    chain."""
    b, h, w, c = x.shape
    if mlp_impl == "fused" and not torch.is_grad_enabled() and beneficial(b * h * w, c):
        (w1, b1), (w2, b2) = full_linear(blk.mlp["fc1"]), full_linear(blk.mlp["fc2"])
        return fused_mlp_residual(x.contiguous(), blk.norm2.weight, blk.norm2.bias, w1, b1, w2, b2)
    y = apply_norm(blk.norm2, x)
    y = apply_linear(blk.mlp["fc2"], gelu(apply_linear(blk.mlp["fc1"], y)))
    return x + y


def swin_block_apply(
    blk: SwinBlock,
    x: torch.Tensor,  # (B, H, W, C)
    num_heads: int,
    ws: int,
    shift: int,
    qk_scale: Optional[float],
    attention: str = "fused",
    mlp_impl: str = "xla",
    fast_math: bool = False,
) -> torch.Tensor:
    b, h, w, c = x.shape
    shortcut = x
    x = apply_norm(blk.norm1, x)
    pad_b = (ws - h % ws) % ws
    pad_r = (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        mask = _device_constant("mask", x.device, hp, wp, ws, shift)
    else:
        mask = None

    n = ws * ws
    xw = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, n, c)
    qkv = apply_linear(blk.attn.qkv, xw)  # (B·nW, N, 3C)
    scale = qk_scale or (c // num_heads) ** -0.5
    if attention == "fused":
        attend = window_attention
    elif attention == "fused_softmax":
        attend = functools.partial(softmax_attention, fast_math=fast_math)
    elif attention == "xla":
        attend = functools.partial(xla_attention, fast_math=fast_math)
    else:
        raise ValueError(f"attention must be one of {ATTENTION}, got {attention!r}")
    xw = attend(qkv, _rel_bias(blk.attn, ws, num_heads), mask, num_heads, scale)
    xw = apply_linear(blk.attn.proj, xw)
    x = xw.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)

    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        x = x[:, :h, :w]
    return _mlp_tail(blk, shortcut + x, mlp_impl)


def _patch_merging(down: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, ⌈H/2⌉, ⌈W/2⌉, 2C); concat order [ee, oe, eo, oo]."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(b, h2, w2, 4 * c)
    return apply_linear(down["reduction"], apply_norm(down["norm"], x))


def swin_apply(
    model: Swin,
    cfg: SwinConfig,
    images: torch.Tensor,  # (B, H, W, 3) normalized
    compute_dtype=torch.bfloat16,
    attention: str = "fused",
    fast_math: bool = False,
) -> Dict[str, torch.Tensor]:
    """{res2..res5: (B, H/s, W/s, C_s)} NHWC feature maps.  ``attention`` picks the
    window-attention branch: ``"fused"`` (Kernel A), ``"fused_softmax"`` (Kernel C) or
    ``"xla"`` (plain PyTorch); ``fast_math`` is ``RbAConfig.fast_math``."""
    x = images.to(compute_dtype)
    p = cfg.patch_size
    h, w = x.shape[1], x.shape[2]
    if h % p or w % p:
        x = F.pad(x, (0, 0, 0, (p - w % p) % p, 0, (p - h % p) % p))
    proj = model.patch_embed["proj"]
    x = F.conv2d(x.permute(0, 3, 1, 2), proj.weight.to(compute_dtype), stride=p).permute(0, 2, 3, 1)
    x = x + proj.bias.to(compute_dtype)  # rounded after the product, as rba_tpu does
    if "norm" in model.patch_embed:
        x = apply_norm(model.patch_embed["norm"], x)
    if cfg.ape:  # resized bicubic in fp32, added in the compute dtype
        x = x + resize_bicubic_nhwc(model.absolute_pos_embed, (x.shape[1], x.shape[2])).to(compute_dtype)

    outs: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(model.layers):
        for j, blk in enumerate(layer.blocks):
            shift = 0 if j % 2 == 0 else cfg.window_size // 2
            args = (blk, x, cfg.num_heads[i], cfg.window_size, shift, cfg.qk_scale, attention, cfg.mlp_impl, fast_math)
            if cfg.use_checkpoint and torch.is_grad_enabled():
                x = checkpoint(swin_block_apply, *args, use_reentrant=False)
            else:
                x = swin_block_apply(*args)
        if f"res{i + 2}" in cfg.out_features:
            outs[f"res{i + 2}"] = apply_norm(getattr(model, f"norm{i}"), x)
        if layer.downsample is not None:
            x = _patch_merging(layer.downsample, x)
    return outs

