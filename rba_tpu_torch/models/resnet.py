"""Detectron2's ResNet-50/101 (counterpart of ``rba_tpu/models/resnet.py``), NHWC.

A 7×7/2 stem conv, frozen batch norm and ReLU, a 3×3/2 max pool, then four stages of
bottlenecks (1×1 → 3×3 → 1×1, a projection shortcut on each stage's first block; the
stride on the 1×1 with ``stride_in_1x1``, else on the 3×3).  The batch norms run with
their running statistics in fp32 and are cast back (``ops.nn.frozen_batch_norm``).
Parameter names follow the JAX pytree: ``stem.conv1``, ``stem.norm1``,
``res3.0.conv2``, ``res3.0.shortcut_norm``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ResNetConfig
from ..ops.nn import apply_conv, frozen_batch_norm, max_pool_nhwc
from .transformer_decoder import BatchNormStats

STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}


def _conv(c_in: int, c_out: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, bottleneck: int, c_out: int, shortcut: bool):
        super().__init__()
        self.conv1, self.norm1 = _conv(c_in, bottleneck, 1), BatchNormStats(bottleneck)
        self.conv2, self.norm2 = _conv(bottleneck, bottleneck, 3), BatchNormStats(bottleneck)
        self.conv3, self.norm3 = _conv(bottleneck, c_out, 1), BatchNormStats(c_out)
        if shortcut:
            self.shortcut, self.shortcut_norm = _conv(c_in, c_out, 1), BatchNormStats(c_out)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.out_strides = {k: STRIDES[k] for k in cfg.out_features}
        self.out_channels = dict(cfg.out_channels)
        self.stem = nn.ModuleDict({"conv1": _conv(3, cfg.stem_out_channels, 7),
                                   "norm1": BatchNormStats(cfg.stem_out_channels)})
        c_in = cfg.stem_out_channels
        for stage, n_blocks in enumerate(cfg.stage_blocks):
            bottleneck, c_out = 64 * 2**stage, 256 * 2**stage
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(c_in, bottleneck, c_out, shortcut=b == 0))
                c_in = c_out
            self.add_module(f"res{stage + 2}", nn.ModuleList(blocks))


def _bottleneck_apply(blk: Bottleneck, x: torch.Tensor, stride: int, stride_in_1x1: bool) -> torch.Tensor:
    s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
    shortcut = x
    if hasattr(blk, "shortcut"):
        shortcut = frozen_batch_norm(apply_conv(blk.shortcut, x, stride=stride), blk.shortcut_norm)
    y = F.relu(frozen_batch_norm(apply_conv(blk.conv1, x, stride=s1), blk.norm1))
    y = F.relu(frozen_batch_norm(apply_conv(blk.conv2, y, stride=s2, padding=1), blk.norm2))
    y = frozen_batch_norm(apply_conv(blk.conv3, y), blk.norm3)
    return F.relu(shortcut + y)


def resnet_apply(model: ResNet, images: torch.Tensor, compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) normalized → {res2..res5} NHWC maps at strides 4..32, in ``compute_dtype``."""
    cfg = model.cfg
    x = apply_conv(model.stem["conv1"], images.to(compute_dtype), stride=2, padding=3)
    x = max_pool_nhwc(F.relu(frozen_batch_norm(x, model.stem["norm1"])), 3, 2, 1)
    outs: Dict[str, torch.Tensor] = {}
    for stage in range(len(cfg.stage_blocks)):
        name = f"res{stage + 2}"
        for b, blk in enumerate(getattr(model, name)):
            stride = 2 if stage > 0 and b == 0 else 1
            x = _bottleneck_apply(blk, x, stride, cfg.stride_in_1x1)
        if name in cfg.out_features:
            outs[name] = x
    return outs
