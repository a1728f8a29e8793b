"""SegFormer's Mix Transformer, MiT-B0…B5 (counterpart of ``rba_tpu/models/mix_transformer.py``), NHWC.

Four stages of an overlapping patch embed (a strided conv and LayerNorm), blocks of
spatial-reduction attention (keys and values from a strided conv of the map) and an
MLP with a 3×3 depthwise conv, and a final LayerNorm; ``res2``…``res5`` at strides
4…32.  LayerNorm eps 1e-6, with the variance centred (``ops.nn.centered_layer_norm``).
The attention rounds as ``rba_tpu``'s does: q·kᵀ in the compute dtype, times the scale
rounded to it, the softmax in fp32 rounded back, ``· v`` summed in fp32 and rounded.  Its
core runs Kernel G (``kernels/sr_attention.py``) where its ``takes`` says so, else the
plain chain ``sr_attention_plain``.
Parameter names follow the JAX pytree: ``stages.2.blocks.5.attn.kv``,
``stages.0.blocks.1.mlp.dwconv``, ``stages.3.norm``.  ``drop_path_rate`` is kept and not
applied, in training too: ``rba_tpu``'s MiT has no stochastic depth and its
``maskformer_forward`` passes the backbone no rng (ROADMAP.md §C.5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from ..kernels import sr_attention as kernel
from ..ops.nn import apply_conv, apply_linear, centered_layer_norm
from ..utils.profiling import SR_ATTENTION, span
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


def _attention(p: nn.ModuleDict, x: torch.Tensor, h: int, w: int, num_heads: int, sr: int) -> torch.Tensor:
    b, n, c = x.shape
    q = apply_linear(p["q"], x)
    kv_in = x
    if sr > 1:
        xs = apply_conv(p["sr"], x.reshape(b, h, w, c), stride=sr, padding="VALID")
        kv_in = centered_layer_norm(xs.reshape(b, -1, c), p["sr_norm"])
    kv = apply_linear(p["kv"], kv_in)
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or kv.requires_grad)
    core = kernel.sr_attention if kernel.takes(q.device, q.dtype, needs_grad, c // num_heads) else sr_attention_plain
    # the core alone (the plain chain's merge of the heads included): the projections, the
    # reduction and proj stay outside
    with span(SR_ATTENTION):
        out = core(q, kv, num_heads)
    return apply_linear(p["proj"], out)


def _mlp(p: nn.ModuleDict, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, n, _ = x.shape
    y = apply_linear(p["fc1"], x)
    hidden = y.shape[-1]
    y = apply_conv(p["dwconv"], y.reshape(b, h, w, hidden), padding=1, groups=hidden)
    return apply_linear(p["fc2"], gelu(y.reshape(b, n, hidden)))


def mit_apply(model: MiT, images: torch.Tensor, compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) normalized → {res2..res5} NHWC maps in ``compute_dtype``."""
    cfg = model.cfg
    x = images.to(compute_dtype)
    outs = {}
    for s, stage in enumerate(model.stages):
        k, stride = PATCH[s]
        x = apply_conv(stage["patch_embed"]["proj"], x, stride=stride, padding=k // 2)
        b, h, w, dim = x.shape
        x = centered_layer_norm(x.reshape(b, h * w, dim), stage["patch_embed"]["norm"])
        for blk in stage["blocks"]:
            x = x + _attention(blk.attn, centered_layer_norm(x, blk.norm1), h, w, cfg.num_heads[s], cfg.sr_ratios[s])
            x = x + _mlp(blk.mlp, centered_layer_norm(x, blk.norm2), h, w)
        x = centered_layer_norm(x, stage["norm"]).reshape(b, h, w, dim)
        outs[f"res{s + 2}"] = x
    return outs
