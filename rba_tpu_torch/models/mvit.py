"""MViTv2 (counterpart of ``rba_tpu/models/mvit.py``), NHWC.

A 7×7/4 patch embed, then blocks of multi-scale attention: q, k and v each pooled by
a 3×3 depthwise conv and a LayerNorm (q by the block's stride, k and v by the
adaptive stride), window attention with decomposed relative positions (global in the
last block of stages 2–4), the pooled q added back, and an MLP; the skip is projected
where the width changes and max-pooled where q is strided.  ``scale2``…``scale5`` at
strides 4…32, each after its own LayerNorm.  It shares ViT's attention chain and
roundings (``vit.attention_core``).  Where ``graphs_take`` says so, the forward replays
as CUDA graphs split at its ``qkv_pool`` and ``rel_pos_attention`` spans
(``cuda_graphs.spanwise``), else it runs eagerly.  Parameter names follow the JAX pytree:
``blocks.2.attn.pool_k``, ``blocks.2.attn.norm_k``, ``blocks.2.proj``, ``scale3_norm``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops.nn import apply_conv, apply_linear, centered_layer_norm, max_pool_nhwc
from ..utils.profiling import QKV_POOL, span
from .cuda_graphs import spanwise
from .swin import gelu
from .vit import abs_pos_embed, attention_core, window_partition, window_unpartition


@dataclass(frozen=True)
class MViTConfig:
    img_size: int = 512
    patch_kernel: Tuple[int, int] = (7, 7)
    patch_stride: Tuple[int, int] = (4, 4)
    patch_padding: Tuple[int, int] = (3, 3)
    embed_dim: int = 96
    depth: int = 24
    num_heads: int = 1
    last_block_indexes: Tuple[int, ...] = (1, 4, 20, 23)
    qkv_pool_kernel: Tuple[int, int] = (3, 3)
    adaptive_kv_stride: int = 4
    adaptive_window_size: int = 56
    residual_pooling: bool = True
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    use_abs_pos: bool = False
    use_rel_pos: bool = True
    pretrain_img_size: int = 224
    pretrain_use_cls_token: bool = True
    out_features: Tuple[str, ...] = ("scale2", "scale3", "scale4", "scale5")
    ln_eps: float = 1e-6


def block_schedule(cfg: MViTConfig) -> List[Dict[str, int]]:
    """Each block's widths, heads, q and kv strides, window and table size, as the
    reference's stage loop sets them."""
    sched = []
    dim = dim_out = cfg.embed_dim
    heads, stride_kv, window = cfg.num_heads, cfg.adaptive_kv_stride, cfg.adaptive_window_size
    input_size = cfg.img_size // cfg.patch_stride[0]
    lbi = cfg.last_block_indexes
    for i in range(cfg.depth):
        sched.append(dict(dim=dim, dim_out=dim_out, heads=heads, stride_q=2 if (i - 1) in lbi else 1,
                          stride_kv=stride_kv * 2 if i in (lbi[1], lbi[2]) else stride_kv,
                          window=0 if i in lbi[1:] else window, input_size=input_size))
        dim = dim_out
        if i in lbi:
            dim_out *= 2
            heads *= 2
            stride_kv = max(stride_kv // 2, 1)
        if (i - 1) in lbi:
            window //= 2
            input_size //= 2
    return sched


class MViTBlock(nn.Module):
    def __init__(self, cfg: MViTConfig, s: Dict[str, int]):
        super().__init__()
        dim, dim_out, eps = s["dim"], s["dim_out"], cfg.ln_eps
        hd, pk = dim_out // s["heads"], cfg.qkv_pool_kernel[0]
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim_out, bias=cfg.qkv_bias)
        self.attn.proj = nn.Linear(dim_out, dim_out)
        for t in "qkv":
            setattr(self.attn, f"pool_{t}", nn.Conv2d(hd, hd, pk, groups=hd, bias=False))
            setattr(self.attn, f"norm_{t}", nn.LayerNorm(hd, eps=eps))
        if cfg.use_rel_pos:
            size = s["input_size"]
            rel_dim = 2 * max(size // s["stride_q"], size // s["stride_kv"]) - 1
            self.attn.rel_pos_h = nn.Parameter(torch.zeros(rel_dim, hd))
            self.attn.rel_pos_w = nn.Parameter(torch.zeros(rel_dim, hd))
        self.norm2 = nn.LayerNorm(dim_out, eps=eps)
        hidden = int(dim_out * cfg.mlp_ratio)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(dim_out, hidden), "fc2": nn.Linear(hidden, dim_out)})
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)


class MViT(nn.Module):
    def __init__(self, cfg: MViTConfig):
        super().__init__()
        self.cfg = cfg
        self.sched = block_schedule(cfg)
        self.out_strides = {f"scale{i + 2}": cfg.patch_stride[0] * 2**i for i in range(4)}
        self.out_channels = {f"scale{i + 2}": cfg.embed_dim * 2**i for i in range(4)}
        self.patch_embed = nn.ModuleDict({"proj": nn.Conv2d(3, cfg.embed_dim, cfg.patch_kernel)})
        if cfg.use_abs_pos:
            n = cfg.pretrain_img_size // cfg.patch_stride[0]
            self.pos_embed = nn.Parameter(torch.zeros(1, n * n + int(cfg.pretrain_use_cls_token), cfg.embed_dim))
        self.blocks = nn.ModuleList(MViTBlock(cfg, s) for s in self.sched)
        for stage, i in enumerate(cfg.last_block_indexes):
            name = f"scale{stage + 2}"
            if name in cfg.out_features:
                self.add_module(f"{name}_norm", nn.LayerNorm(self.sched[i]["dim_out"], eps=cfg.ln_eps))


def _pool(conv: nn.Conv2d, norm: nn.LayerNorm, x: torch.Tensor, stride: int) -> torch.Tensor:
    """3×3 depthwise pooling conv and LayerNorm of (B·heads, H, W, hd)."""
    return centered_layer_norm(apply_conv(conv, x, stride=stride, padding=1, groups=x.shape[-1]), norm)


def _ms_attention(attn: nn.Module, x: torch.Tensor, s: Dict[str, int], cfg: MViTConfig) -> torch.Tensor:
    b, h, w, _ = x.shape
    heads = s["heads"]
    hd = attn.proj.weight.shape[0] // heads
    qkv = apply_linear(attn.qkv, x).reshape(b, h, w, 3, heads, hd).permute(3, 0, 4, 1, 2, 5)
    q, k, v = qkv.reshape(3, b * heads, h, w, hd)
    with span(QKV_POOL):
        q = _pool(attn.pool_q, attn.norm_q, q, s["stride_q"])
        k = _pool(attn.pool_k, attn.norm_k, k, s["stride_kv"])
        v = _pool(attn.pool_v, attn.norm_v, v, s["stride_kv"])
    ori_q = q
    ws = s["window"]
    if ws:
        q_ws, kv_ws = ws // s["stride_q"], ws // s["stride_kv"]
        q, q_pad = window_partition(q, q_ws)
        k, _ = window_partition(k, kv_ws)
        v, _ = window_partition(v, kv_ws)
        q_hw, kv_hw = (q_ws, q_ws), (kv_ws, kv_ws)
    else:
        q_hw, kv_hw = tuple(q.shape[1:3]), tuple(k.shape[1:3])
    rel = (attn.rel_pos_h, attn.rel_pos_w) if cfg.use_rel_pos else (None, None)
    out = attention_core(q.reshape(q.shape[0], -1, hd), k.reshape(k.shape[0], -1, hd), v.reshape(v.shape[0], -1, hd),
                         q_hw, kv_hw, *rel).reshape(-1, q_hw[0], q_hw[1], hd)
    if ws:
        out = window_unpartition(out, q_ws, q_pad, tuple(ori_q.shape[1:3]))
    if cfg.residual_pooling:
        out = out + ori_q
    oh, ow = out.shape[1], out.shape[2]
    out = out.reshape(b, heads, oh, ow, hd).permute(0, 2, 3, 1, 4).reshape(b, oh, ow, heads * hd)
    return apply_linear(attn.proj, out)


def graphs_take(device: torch.device, grad_enabled: bool) -> bool:
    """Whether ``mvit_apply`` replays the forward as CUDA graphs split at its spans
    (``cuda_graphs.spanwise``): on CUDA with autograd off.  Elsewhere (the CPU,
    training) the forward runs eagerly."""
    return device.type == "cuda" and not grad_enabled


def mvit_apply(model: MViT, images: torch.Tensor, compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) normalized → {scale2..scale5} NHWC maps in ``compute_dtype``.  Where
    ``graphs_take`` says so, the forward replays as CUDA graphs captured at an input
    shape's second call, one for each ``qkv_pool`` and ``rel_pos_attention`` span,
    replayed inside it, and one for each stretch between them; else it runs eagerly."""
    graphed = graphs_take(images.device, torch.is_grad_enabled())
    return spanwise(model, lambda x: _forward(model, x, compute_dtype), images, key=compute_dtype if graphed else None)


def _forward(model: MViT, images: torch.Tensor, compute_dtype) -> Dict[str, torch.Tensor]:
    cfg = model.cfg
    x = apply_conv(model.patch_embed["proj"], images.to(compute_dtype), stride=cfg.patch_stride[0],
                   padding=cfg.patch_padding[0])
    if cfg.use_abs_pos:
        x = x + abs_pos_embed(model.pos_embed, (x.shape[1], x.shape[2]), cfg.pretrain_use_cls_token).to(compute_dtype)
    outs: Dict[str, torch.Tensor] = {}
    stage = 2
    for i, (blk, s) in enumerate(zip(model.blocks, model.sched)):
        xn = centered_layer_norm(x, blk.norm1)
        att = _ms_attention(blk.attn, xn, s, cfg)
        skip = apply_linear(blk.proj, xn) if hasattr(blk, "proj") else x
        if s["stride_q"] > 1:
            ksz = s["stride_q"] + 1
            skip = max_pool_nhwc(skip, ksz, s["stride_q"], ksz // 2)
        x = skip + att
        x = x + apply_linear(blk.mlp["fc2"], gelu(apply_linear(blk.mlp["fc1"], centered_layer_norm(x, blk.norm2))))
        if i in cfg.last_block_indexes:
            name = f"scale{stage}"
            if name in cfg.out_features:
                outs[name] = centered_layer_norm(x, getattr(model, f"{name}_norm"))
            stage += 1
    return outs
