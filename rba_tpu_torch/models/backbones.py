"""The backbone of a config, by ``backbone_name`` (counterpart of ``rba_tpu/models/backbones.py``).

``build_backbone(cfg)`` makes the backbone's module, which carries ``out_channels`` and
``out_strides`` by feature name; ``backbone_apply`` runs it, Swin aside.  The families
and their fixed configs are the JAX package's: Swin (``cfg.swin``), ResNet
(``cfg.resnet``), MiT (``mix_transformer`` or ``mit_b0``…``mit_b5``), ViT
(``ViTConfig()``), ViT with the SimpleFeaturePyramid (``vit_sfp``, the pyramid at
``pixel_decoder.conv_dim``), MViTv2 (``MViTConfig()``) and WiderResNet-38
(``WideResNetConfig()``).  Swin and MiT run kernels: ``maskformer.maskformer_forward``
calls ``swin.swin_apply`` for Swin with its ``attention`` and ``fast_math`` arguments,
and MiT runs Kernel G in each block's attention core.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import RbAConfig
from .mix_transformer import MIT_VARIANTS, MiT, mit_apply
from .mvit import MViT, MViTConfig, mvit_apply
from .resnet import ResNet, resnet_apply
from .swin import Swin
from .vit import SFP_NAMES, SimpleFeaturePyramid, ViT, ViTConfig, sfp_apply, vit_apply
from .wideresnet import WideResNet, WideResNetConfig, wideresnet_apply

class ViTSFP(nn.Module):
    """ViT and its pyramid: ``vit`` and ``sfp`` in the JAX tree."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.vit = ViT(ViTConfig())
        self.sfp = SimpleFeaturePyramid(self.vit.cfg.embed_dim, out_channels)
        self.out_channels = {name: out_channels for name in SFP_NAMES.values()}
        self.out_strides = {name: int(self.vit.cfg.patch_size / scale) for scale, name in SFP_NAMES.items()}


def build_backbone(cfg: RbAConfig) -> nn.Module:
    name = cfg.backbone_name
    if name == "swin":
        return Swin(cfg.swin)
    if name == "resnet":
        return ResNet(cfg.resnet)
    if name == "mix_transformer" or name in MIT_VARIANTS:
        return MiT(MIT_VARIANTS[name if name in MIT_VARIANTS else "mit_b0"])
    if name == "vit":
        return ViT(ViTConfig())
    if name == "vit_sfp":
        return ViTSFP(cfg.pixel_decoder.conv_dim)
    if name == "mvit":
        return MViT(MViTConfig())
    if name == "wideresnet38":
        return WideResNet(WideResNetConfig())
    raise NotImplementedError(f"backbone {name!r}")


def backbone_apply(
    model: nn.Module,
    cfg: RbAConfig,
    images: torch.Tensor,  # (B, H, W, 3) normalized
    compute_dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """The NHWC feature maps by name, in ``compute_dtype``, of a backbone other than Swin
    (Swin runs through ``swin.swin_apply``, which picks its kernels)."""
    name = cfg.backbone_name
    if name == "resnet":
        return resnet_apply(model, images, compute_dtype)
    if name == "mix_transformer" or name in MIT_VARIANTS:
        return mit_apply(model, images, compute_dtype)
    if name == "vit":
        return vit_apply(model, images, compute_dtype)
    if name == "vit_sfp":
        return sfp_apply(model.sfp, vit_apply(model.vit, images, compute_dtype)["last_feat"])
    if name == "mvit":
        return mvit_apply(model, images, compute_dtype)
    if name == "wideresnet38":
        return wideresnet_apply(model, images, compute_dtype)
    raise NotImplementedError(f"backbone {name!r}")
