"""Configuration of the PyTorch port: the fields the Swin-B RbA scoring path reads.

A copy, not an import, of the matching dataclasses in ``rba_tpu/config.py``
(``SwinConfig``, ``PixelDecoderConfig``, ``DecoderConfig``, the test-time part
of ``InputConfig`` and the model part of ``RbAConfig``) and of its presets.
Field names and defaults are the same, so a config of one package can be
rebuilt field by field in the other.  Options the port does not run yet keep
their field and are refused by ``check_supported``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    ape: bool = False
    patch_norm: bool = True
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    attn_layout: str = "partition"
    mlp_impl: str = "xla"

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2**i)

    @property
    def out_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": self.stage_dim(i) for i in range(self.num_layers)}


@dataclass(frozen=True)
class PixelDecoderConfig:
    conv_dim: int = 256
    mask_dim: int = 256
    norm: str = "GN"
    transformer_in_features: Tuple[str, ...] = ("res5",)
    in_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    transformer_enc_layers: int = 6
    transformer_nheads: int = 8
    enc_n_points: int = 4
    transformer_dim_feedforward: int = 1024
    name: str = "MSDeformAttnPixelDecoder"

    @property
    def num_feature_levels(self) -> int:
        return len(self.transformer_in_features)


@dataclass(frozen=True)
class DecoderConfig:
    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 1
    pre_norm: bool = False
    mask_dim: int = 256
    enforce_input_project: bool = False
    num_feature_levels: int = 1
    ood_prediction: bool = False
    name: str = "MultiScaleMaskedTransformerDecoder"


@dataclass(frozen=True)
class InputConfig:
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    size_divisibility: int = 32


@dataclass(frozen=True)
class RbAConfig:
    backbone_name: str = "swin"
    sem_seg_head_name: str = "MaskFormerHead"
    swin: SwinConfig = field(default_factory=SwinConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    input: InputConfig = field(default_factory=InputConfig)
    num_classes: int = 19
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pixel_decoder_dtype: str = "float32"
    fast_math: bool = False
    weight_quant: str = "none"


def check_supported(cfg: RbAConfig) -> None:
    """Raise ``NotImplementedError`` for an option that no slice of the port runs yet."""
    later = {
        "backbones other than Swin": cfg.backbone_name != "swin",
        "per-pixel baseline heads": cfg.sem_seg_head_name != "MaskFormerHead",
        "pixel decoders other than MSDeformAttn": cfg.pixel_decoder.name != "MSDeformAttnPixelDecoder",
        "decoders other than the masked-attention one": cfg.decoder.name != "MultiScaleMaskedTransformerDecoder",
        "the DenseHybrid ood_pred head": cfg.decoder.ood_prediction,
        "pre-norm decoder layers": cfg.decoder.pre_norm,
        "Swin attention layouts other than partition": cfg.swin.attn_layout != "partition",
        f"Swin mlp_impl={cfg.swin.mlp_impl!r}": cfg.swin.mlp_impl not in ("xla", "fused"),
        "Swin absolute position embedding": cfg.swin.ape,
        "fast_math (the fast_serving slice)": cfg.fast_math,
        "a bf16 pixel decoder (the fast_serving slice)": cfg.pixel_decoder_dtype != "float32",
        "weight_quant": cfg.weight_quant != "none",
        "param_dtype other than float32": cfg.param_dtype != "float32",
        "GroupNorm-free pixel decoders": cfg.pixel_decoder.norm != "GN",
    }
    missing = [name for name, hit in later.items() if hit]
    if missing:
        raise NotImplementedError(
            "not ported yet (a later slice of the PyTorch port): " + ", ".join(missing)
        )
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")


# Presets matching the released checkpoints' architectures.
def swin_b_1dl() -> RbAConfig:
    return RbAConfig()


def swin_l_1dl() -> RbAConfig:
    return dataclasses.replace(
        RbAConfig(),
        swin=dataclasses.replace(SwinConfig(), embed_dim=192, num_heads=(6, 12, 24, 48)),
    )


def tiny_test_config(num_classes: int = 7) -> RbAConfig:
    """A miniature config for fast CPU tests."""
    return RbAConfig(
        swin=SwinConfig(
            embed_dim=32,
            depths=(2, 2),
            num_heads=(2, 4),
            window_size=4,
            out_features=("res2", "res3"),
        ),
        pixel_decoder=PixelDecoderConfig(
            conv_dim=64,
            mask_dim=64,
            transformer_in_features=("res3",),
            in_features=("res2", "res3"),
            transformer_enc_layers=2,
            transformer_nheads=4,
            transformer_dim_feedforward=128,
        ),
        decoder=DecoderConfig(
            hidden_dim=64,
            num_queries=10,
            nheads=4,
            dim_feedforward=128,
            dec_layers=2,
            mask_dim=64,
            num_feature_levels=1,
        ),
        num_classes=num_classes,
        compute_dtype="float32",
    )
