"""SegFormer's Mix Transformer, MiT-B0…B5 (counterpart of ``rba_tpu/models/mix_transformer.py``), NHWC.

Four stages of an overlapping patch embed (a strided conv and LayerNorm), blocks of
spatial-reduction attention (keys and values from a strided conv of the map) and an
MLP with a 3×3 depthwise conv, and a final LayerNorm; ``res2``…``res5`` at strides
4…32.  LayerNorm eps 1e-6, with the variance centred (``ops.nn.centered_layer_norm``).
The attention rounds as ``rba_tpu``'s does: q·kᵀ in the compute dtype, times the scale
rounded to it, the softmax in fp32 rounded back, ``· v`` summed in fp32 and rounded.  Its
core runs Kernel G (``kernels/sr_attention.py``) where its ``takes`` says so, else the
plain chain ``sr_attention_plain``.  The forward is written once, as a generator that
stops at each core (``_forward``); where ``graphs_take`` says so, the stretches between
the cores replay as CUDA graphs (``cuda_graphs.piecewise``), else it runs eagerly.
Parameter names follow the JAX pytree: ``stages.2.blocks.5.attn.kv``,
``stages.0.blocks.1.mlp.dwconv``, ``stages.3.norm``.  ``drop_path_rate`` is kept and not
applied, in training too: ``rba_tpu``'s MiT has no stochastic depth and its
``maskformer_forward`` passes the backbone no rng (ROADMAP.md §C.5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels import sr_attention as kernel
from ..ops.nn import apply_conv, apply_linear, centered_layer_norm
from ..utils.profiling import SR_ATTENTION, span
from .cuda_graphs import piecewise
from .swin import gelu
from .vit import scaled


@dataclass(frozen=True)
class MiTConfig:
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    ln_eps: float = 1e-6


MIT_VARIANTS = {
    "mit_b0": MiTConfig(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": MiTConfig(depths=(2, 2, 2, 2)),
    "mit_b2": MiTConfig(depths=(3, 4, 6, 3)),
    "mit_b3": MiTConfig(depths=(3, 4, 18, 3)),
    "mit_b4": MiTConfig(depths=(3, 8, 27, 3)),
    "mit_b5": MiTConfig(depths=(3, 6, 40, 3)),
}

PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))  # (kernel, stride) of each stage's patch embed


class MiTBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, sr: int, qkv_bias: bool, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = nn.ModuleDict({"q": nn.Linear(dim, dim, bias=qkv_bias), "kv": nn.Linear(dim, 2 * dim, bias=qkv_bias),
                                   "proj": nn.Linear(dim, dim)})
        if sr > 1:
            self.attn["sr"] = nn.Conv2d(dim, dim, sr, stride=sr)
            self.attn["sr_norm"] = nn.LayerNorm(dim, eps=eps)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(dim, hidden), "dwconv": nn.Conv2d(hidden, hidden, 3, groups=hidden),
                                  "fc2": nn.Linear(hidden, dim)})


class MiT(nn.Module):
    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.cfg = cfg
        self.out_strides = {f"res{s + 2}": 4 * 2**s for s in range(4)}
        self.out_channels = {f"res{s + 2}": cfg.embed_dims[s] for s in range(4)}
        stages, c_in = [], 3
        for s, dim in enumerate(cfg.embed_dims):
            k, _ = PATCH[s]
            stages.append(nn.ModuleDict({
                "patch_embed": nn.ModuleDict({"proj": nn.Conv2d(c_in, dim, k), "norm": nn.LayerNorm(dim, eps=cfg.ln_eps)}),
                "blocks": nn.ModuleList(MiTBlock(dim, dim * cfg.mlp_ratios[s], cfg.sr_ratios[s], cfg.qkv_bias, cfg.ln_eps)
                                        for _ in range(cfg.depths[s])),
                "norm": nn.LayerNorm(dim, eps=cfg.ln_eps),
            }))
            c_in = dim
        self.stages = nn.ModuleList(stages)


def sr_attention_plain(
    q: torch.Tensor,  # (B, N, C), the q linear's output
    kv: torch.Tensor,  # (B, M, 2C), the kv linear's output: k, then v
    num_heads: int,
) -> torch.Tensor:  # (B, N, C)
    """The attention core in plain PyTorch, Kernel G's plain version: q·kᵀ in the input
    dtype, times ``hd**-0.5`` rounded to it, the softmax in fp32 rounded back, ``· v``."""
    b, n, c = q.shape
    hd = c // num_heads
    q = q.reshape(b, n, num_heads, hd).transpose(1, 2)
    k, v = kv.reshape(b, -1, 2, num_heads, hd).permute(2, 0, 3, 1, 4)
    attn = scaled(torch.matmul(q, k.transpose(-1, -2)), hd**-0.5)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    out = torch.matmul(attn, v)  # rba_tpu sums in fp32 and rounds once, as the product does here
    return out.transpose(1, 2).reshape(b, n, c)


def graphs_take(cfg: MiTConfig, device: torch.device, compute_dtype: torch.dtype, grad_enabled: bool) -> bool:
    """Whether ``mit_apply`` replays the forward as CUDA graphs split at the attention
    cores (``cuda_graphs.piecewise``): on CUDA, with autograd off, where Kernel G's
    ``takes`` takes every block's core (bf16, its head dims, not under
    ``plain_versions()``).  Elsewhere the forward runs eagerly: the CPU, training, fp32."""
    return not grad_enabled and all(kernel.takes(device, compute_dtype, False, dim // heads)
                                    for dim, heads in zip(cfg.embed_dims, cfg.num_heads))


def _core(q: torch.Tensor, kv: torch.Tensor, num_heads: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block's attention core, alone in its span (the plain chain's merge of the heads
    included): Kernel G where its ``takes`` says so, into ``out`` where given, else the
    plain chain."""
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or kv.requires_grad)
    fused = kernel.takes(q.device, q.dtype, needs_grad, q.shape[-1] // num_heads)
    with span(SR_ATTENTION):
        return kernel.sr_attention(q, kv, num_heads, out=out) if fused else sr_attention_plain(q, kv, num_heads)


def _attention(p: nn.ModuleDict, x: torch.Tensor, h: int, w: int, num_heads: int, sr: int):
    """The block's attention, a generator: it yields the core's arguments, is sent the
    core's output and returns ``proj`` of it.  The projections, the reduction and
    ``proj`` stay outside the core."""
    b, n, c = x.shape
    q = apply_linear(p["q"], x)
    kv_in = x
    if sr > 1:
        xs = apply_conv(p["sr"], x.reshape(b, h, w, c), stride=sr, padding="VALID")
        kv_in = centered_layer_norm(xs.reshape(b, -1, c), p["sr_norm"])
    kv = apply_linear(p["kv"], kv_in)
    out = yield q, kv, num_heads
    return apply_linear(p["proj"], out)


def _mlp(p: nn.ModuleDict, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, n, _ = x.shape
    y = apply_linear(p["fc1"], x)
    hidden = y.shape[-1]
    y = apply_conv(p["dwconv"], y.reshape(b, h, w, hidden), padding=1, groups=hidden)
    return apply_linear(p["fc2"], gelu(y.reshape(b, n, hidden)))


def _forward(model: MiT, images: torch.Tensor, compute_dtype):
    """The forward as a generator that stops at each block's attention core: it yields
    ``(q, kv, heads)`` and is sent the core's output; it returns {res2..res5}."""
    cfg = model.cfg
    x = images.to(compute_dtype)
    outs = {}
    for s, stage in enumerate(model.stages):
        k, stride = PATCH[s]
        x = apply_conv(stage["patch_embed"]["proj"], x, stride=stride, padding=k // 2)
        b, h, w, dim = x.shape
        x = centered_layer_norm(x.reshape(b, h * w, dim), stage["patch_embed"]["norm"])
        for blk in stage["blocks"]:
            x = x + (yield from _attention(blk.attn, centered_layer_norm(x, blk.norm1), h, w, cfg.num_heads[s],
                                           cfg.sr_ratios[s]))
            x = x + _mlp(blk.mlp, centered_layer_norm(x, blk.norm2), h, w)
        x = centered_layer_norm(x, stage["norm"]).reshape(b, h, w, dim)
        outs[f"res{s + 2}"] = x
    return outs


def mit_apply(model: MiT, images: torch.Tensor, compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) normalized → {res2..res5} NHWC maps in ``compute_dtype``.  Where
    ``graphs_take`` says so, the stretches between the attention cores replay as CUDA
    graphs, captured at an input shape's second call, and Kernel G runs eagerly between
    them, in its spans; else the forward runs eagerly."""
    graphed = graphs_take(model.cfg, images.device, compute_dtype, torch.is_grad_enabled())
    return piecewise(model, lambda x: _forward(model, x, compute_dtype), images, _core,
                     key=compute_dtype if graphed else None)
