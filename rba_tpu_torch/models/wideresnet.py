"""WiderResNet-A2 38 (counterpart of ``rba_tpu/models/wideresnet.py``), NHWC.

A 3×3 stem (``mod1``), max pools before ``mod2`` and ``mod3``, then six modules of
pre-activation residual blocks (frozen BN + ReLU, two 3×3 convs or a 1×1 → 3×3 → 1×1
bottleneck, a 1×1 projection where the shape changes).  With ``dilation`` the map stays
at stride 8 from ``mod4`` on and ``mod5``–``mod7`` dilate by 2, 4, 4.  Outputs ``res4``…
``res7`` and ``res7_bn`` (the final BN + ReLU), all at stride 8.  The batch norms run in
fp32 and are cast back.  Parameter names follow the JAX pytree: ``mod1``,
``mod5.0.bn1``, ``mod6.0.conv3``, ``mod4.0.proj_conv``, ``bn_out``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..ops.nn import apply_conv, frozen_batch_norm, max_pool_nhwc
from .transformer_decoder import BatchNormStats

# the internal channels of each module, mod2..mod7 (the public WiderResNet-A2 definition)
MODULE_CHANNELS: Tuple[Tuple[int, ...], ...] = (
    (128, 128),
    (256, 256),
    (512, 512),
    (512, 1024),
    (512, 1024, 2048),
    (1024, 2048, 4096),
)


@dataclass(frozen=True)
class WideResNetConfig:
    structure: Tuple[int, ...] = (3, 3, 6, 3, 1, 1)
    dilation: bool = True


def first_block_stride(mod: int, dilation: bool) -> int:
    """mod4 always downsamples with a strided first block; mod5 and mod6 do only without
    dilation, which replaces their stride."""
    return 2 if mod == 4 or (mod in (5, 6) and not dilation) else 1


def dilation_of(mod: int, dilation: bool) -> int:
    return {2: 1, 3: 1, 4: 1, 5: 2, 6: 4, 7: 4}[mod] if dilation else 1


class IdentityResidualBlock(nn.Module):
    def __init__(self, c_in: int, channels: Sequence[int], stride: int):
        super().__init__()
        self.bn1 = BatchNormStats(c_in)
        if len(channels) == 2:
            self.conv1 = nn.Conv2d(c_in, channels[0], 3, bias=False)
        else:
            self.conv1 = nn.Conv2d(c_in, channels[0], 1, bias=False)
        self.bn2 = BatchNormStats(channels[0])
        self.conv2 = nn.Conv2d(channels[0], channels[1], 3, bias=False)
        if len(channels) == 3:
            self.bn3 = BatchNormStats(channels[1])
            self.conv3 = nn.Conv2d(channels[1], channels[2], 1, bias=False)
        if stride != 1 or c_in != channels[-1]:
            self.proj_conv = nn.Conv2d(c_in, channels[-1], 1, bias=False)


class WideResNet(nn.Module):
    def __init__(self, cfg: WideResNetConfig = WideResNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.out_strides = {"res4": 8, "res5": 8, "res6": 8, "res7": 8, "res7_bn": 8} if cfg.dilation else \
            {"res4": 8, "res5": 16, "res6": 32, "res7": 32, "res7_bn": 32}
        self.out_channels = {"res4": 512, "res5": 1024, "res6": 2048, "res7": 4096, "res7_bn": 4096}
        self.mod1 = nn.Conv2d(3, 64, 3, bias=False)
        c_in = 64
        for mod in range(2, 8):
            chans = MODULE_CHANNELS[mod - 2]
            blocks = []
            for b in range(cfg.structure[mod - 2]):
                blocks.append(IdentityResidualBlock(c_in, chans, first_block_stride(mod, cfg.dilation) if b == 0 else 1))
                c_in = chans[-1]
            self.add_module(f"mod{mod}", nn.ModuleList(blocks))
        self.bn_out = BatchNormStats(c_in)


def _dilated_conv(conv: nn.Conv2d, x: torch.Tensor, stride: int, dilation: int) -> torch.Tensor:
    return apply_conv(conv, x, stride=stride, padding=dilation, dilation=dilation, dot_1x1=False)


def _block_apply(blk: IdentityResidualBlock, x: torch.Tensor, stride: int, dilation: int) -> torch.Tensor:
    y = frozen_batch_norm(x, blk.bn1, relu=True)
    shortcut = apply_conv(blk.proj_conv, y, stride=stride) if hasattr(blk, "proj_conv") else x
    if hasattr(blk, "conv3"):  # bottleneck
        z = apply_conv(blk.conv1, y, stride=stride, padding="VALID", dot_1x1=False)
        z = _dilated_conv(blk.conv2, frozen_batch_norm(z, blk.bn2, relu=True), 1, dilation)
        z = apply_conv(blk.conv3, frozen_batch_norm(z, blk.bn3, relu=True))
    else:
        z = _dilated_conv(blk.conv1, y, stride, dilation)
        z = _dilated_conv(blk.conv2, frozen_batch_norm(z, blk.bn2, relu=True), 1, dilation)
    return shortcut + z


def wideresnet_apply(model: WideResNet, images: torch.Tensor, compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) normalized → {res4..res7, res7_bn} NHWC maps in ``compute_dtype``."""
    cfg = model.cfg
    x = apply_conv(model.mod1, images.to(compute_dtype), padding=1)
    outs: Dict[str, torch.Tensor] = {}
    for mod in range(2, 8):
        if mod in (2, 3):
            x = max_pool_nhwc(x, 3, 2, 1)
        for b, blk in enumerate(getattr(model, f"mod{mod}")):
            stride = first_block_stride(mod, cfg.dilation) if b == 0 else 1
            x = _block_apply(blk, x, stride, dilation_of(mod, cfg.dilation))
        if mod >= 4:
            outs[f"res{mod}"] = x
    outs["res7_bn"] = frozen_batch_norm(x, model.bn_out, relu=True)
    return outs
