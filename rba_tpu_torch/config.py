"""Configuration of the PyTorch port: the fields the Swin-B RbA scoring path reads.

A copy, not an import, of the matching dataclasses in ``rba_tpu/config.py``
(``SwinConfig``, ``PixelDecoderConfig``, ``DecoderConfig``, the test-time part
of ``InputConfig``, the test-time augmentation fields of ``TestConfig`` and the
model part of ``RbAConfig``) and of its presets.
Field names and defaults are the same, so a config of one package can be
rebuilt field by field in the other.  Options the port does not run yet keep
their field and are refused by ``check_supported``.  ``load_d2_config`` reads a
Detectron2 ``config.yaml`` (with its ``_BASE_`` chain) into these fields, with the
values ``rba_tpu.config.load_d2_config`` gives them.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


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
    common_stride: int = 4
    name: str = "MSDeformAttnPixelDecoder"
    # deformable sampling per level: "gather", "onehot" (a dense (Lq, HW) row matrix of
    # the corners' weights), or "auto": onehot where N·M·Lq·H·W <= sampling_onehot_cap
    sampling_method: str = "auto"
    # "bfloat16": the one-hot row matrix and the values rounded to bf16, fp32 sums
    sampling_dtype: str = "float32"
    sampling_onehot_cap: int = 192 * 1024 * 1024

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
class TestConfig:
    """Test-time augmentation (Detectron2's ``TEST.AUG``): the shortest edge resized to
    each of ``aug_min_sizes`` (the longest capped at ``aug_max_size``), each also
    flipped horizontally when ``aug_flip``."""
    aug_enabled: bool = False
    aug_flip: bool = True
    aug_min_sizes: Tuple[int, ...] = (512, 768, 1024, 1280, 1536, 1792)
    aug_max_size: int = 4096


@dataclass(frozen=True)
class RbAConfig:
    backbone_name: str = "swin"
    sem_seg_head_name: str = "MaskFormerHead"
    swin: SwinConfig = field(default_factory=SwinConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    input: InputConfig = field(default_factory=InputConfig)
    test: TestConfig = field(default_factory=TestConfig)
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
        "pre-norm decoder layers": cfg.decoder.pre_norm,
        "Swin attention layouts other than partition": cfg.swin.attn_layout != "partition",
        f"Swin mlp_impl={cfg.swin.mlp_impl!r}": cfg.swin.mlp_impl not in ("xla", "fused"),
        "Swin absolute position embedding": cfg.swin.ape,
        "weight_quant": cfg.weight_quant != "none",
        "param_dtype other than float32": cfg.param_dtype != "float32",
        "GroupNorm-free pixel decoders": cfg.pixel_decoder.norm != "GN",
        f"sampling_method={cfg.pixel_decoder.sampling_method!r}":
            cfg.pixel_decoder.sampling_method not in ("auto", "gather", "onehot"),
    }
    missing = [name for name, hit in later.items() if hit]
    if missing:
        raise NotImplementedError(
            "not ported yet (a later slice of the PyTorch port): " + ", ".join(missing)
        )
    for name in ("compute_dtype", "pixel_decoder_dtype"):
        if getattr(cfg, name) not in ("float32", "bfloat16"):
            raise ValueError(f"{name} {getattr(cfg, name)!r}")
    if cfg.pixel_decoder.sampling_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"sampling_dtype {cfg.pixel_decoder.sampling_dtype!r}")


# ---------------------------------------------------------------------------
# Detectron2 YAML: _BASE_ inheritance and the !!python eval tag, which the
# reference configs use for MIN_SIZE_TRAIN.  yaml is imported where a file is
# read, so the package imports without PyYAML.
# ---------------------------------------------------------------------------

def _eval_constructor(loader, node):
    (expr,) = loader.construct_sequence(node)
    # the corpus only uses range/int arithmetic; no builtins beyond these
    return eval(expr, {"__builtins__": {}}, {"range": range, "int": int, "float": float})


def _d2_yaml_loader():
    import yaml

    class _D2YamlLoader(yaml.SafeLoader):
        pass

    _D2YamlLoader.add_constructor("tag:yaml.org,2002:python/object/apply:eval", _eval_constructor)
    return _D2YamlLoader


def _deep_merge(base: Dict, child: Dict) -> Dict:
    out = dict(base)
    for k, v in child.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_with_base(path: str) -> Dict[str, Any]:
    """Load a D2 YAML, following relative ``_BASE_`` chains and deep-merging
    the child over its base (child wins)."""
    import yaml

    with open(path) as f:
        raw = yaml.load(f, Loader=_d2_yaml_loader()) or {}
    base_rel = raw.pop("_BASE_", None)
    if base_rel:
        base_path = base_rel if os.path.isabs(base_rel) else os.path.join(
            os.path.dirname(os.path.abspath(path)), base_rel
        )
        raw = _deep_merge(load_yaml_with_base(base_path), raw)
    return raw


def _get(d: Dict[str, Any], path: str, default=None):
    cur: Any = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


# config feature names → backbone output keys: the MiT backbone's stage1..4 are
# emitted as res2..res5
_FEATURE_ALIASES = {"stage1": "res2", "stage2": "res3", "stage3": "res4", "stage4": "res5"}


def _features(names) -> Tuple[str, ...]:
    return tuple(_FEATURE_ALIASES.get(n, n) for n in names)


def _int(v, default: int) -> int:
    """Tolerant int coercion: the reference corpus contains a literal typo
    (wideresnet 1dl config ``DEC_LAYERS: 2z``) that YAML reads as a string —
    take the leading integer rather than refusing the whole config."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return int(v)
    import re

    m = re.match(r"\s*(-?\d+)", str(v))
    return int(m.group(1)) if m else default


_BACKBONES = {
    "D2SwinTransformer": "swin",
    "D2ViT": "vit",
    "D2MViT": "mvit",
    "build_wideresnet38_backbone": "wideresnet38",
    "build_wideresnet_backbone": "wideresnet38",
    "WiderResNetA2": "wideresnet38",
    "WiderResNet38A2": "wideresnet38",
    "build_resnet_backbone": "resnet",
    "build_resnet_deeplab_backbone": "resnet",
}


def load_d2_config(path: str, **overrides) -> RbAConfig:
    """Read a frozen Detectron2 ``config.yaml`` of the reference release into the
    port's config.  Only the keys behind the port's fields are read, each as
    ``rba_tpu.config.load_d2_config`` reads it; a backbone or head that the port does
    not run yet loads and is refused by ``check_supported``."""
    raw = load_yaml_with_base(path)

    model = raw.get("MODEL", {})
    swin_raw = model.get("SWIN", {})
    mf = model.get("MASK_FORMER", {})
    head = model.get("SEM_SEG_HEAD", {})

    name_raw = str(_get(model, "BACKBONE.NAME", ""))
    backbone = _BACKBONES.get(_get(model, "BACKBONE.NAME", "D2SwinTransformer"), "swin")
    if name_raw.startswith("mit"):
        backbone = name_raw  # keep the variant (mit_b0..mit_b5)

    swin = SwinConfig(
        patch_size=swin_raw.get("PATCH_SIZE", 4),
        embed_dim=swin_raw.get("EMBED_DIM", 128),
        depths=tuple(swin_raw.get("DEPTHS", (2, 2, 18, 2))),
        num_heads=tuple(swin_raw.get("NUM_HEADS", (4, 8, 16, 32))),
        window_size=swin_raw.get("WINDOW_SIZE", 12),
        mlp_ratio=swin_raw.get("MLP_RATIO", 4.0),
        qkv_bias=swin_raw.get("QKV_BIAS", True),
        qk_scale=swin_raw.get("QK_SCALE", None),
        ape=swin_raw.get("APE", False),
        patch_norm=swin_raw.get("PATCH_NORM", True),
        out_features=tuple(swin_raw.get("OUT_FEATURES", ("res2", "res3", "res4", "res5"))),
    )
    pixel_decoder = PixelDecoderConfig(
        conv_dim=head.get("CONVS_DIM", 256),
        mask_dim=head.get("MASK_DIM", 256),
        norm=head.get("NORM", "GN"),
        transformer_in_features=_features(head.get("DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES", ("res5",))),
        in_features=_features(head.get("IN_FEATURES", ("res2", "res3", "res4", "res5"))),
        transformer_enc_layers=head.get("TRANSFORMER_ENC_LAYERS", 6),
        transformer_nheads=mf.get("NHEADS", 8),
        enc_n_points=head.get("DEFORMABLE_TRANSFORMER_ENCODER_N_POINTS", 4),
        common_stride=head.get("COMMON_STRIDE", 4),
        name=head.get("PIXEL_DECODER_NAME", "MSDeformAttnPixelDecoder"),
    )
    decoder = DecoderConfig(
        hidden_dim=mf.get("HIDDEN_DIM", 256),
        num_queries=mf.get("NUM_OBJECT_QUERIES", 100),
        nheads=mf.get("NHEADS", 8),
        dim_feedforward=mf.get("DIM_FEEDFORWARD", 2048),
        # the reference's from_config subtracts 1 from DEC_LAYERS
        dec_layers=max(_int(mf.get("DEC_LAYERS", 2), 2) - 1, 1),
        pre_norm=mf.get("PRE_NORM", False),
        mask_dim=head.get("MASK_DIM", 256),
        enforce_input_project=mf.get("ENFORCE_INPUT_PROJ", False),
        num_feature_levels=len(head.get("DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES", ("res5",))),
        ood_prediction=mf.get("DENSE_HYBRID_LOSS", False),
        name=mf.get("TRANSFORMER_DECODER_NAME", "MultiScaleMaskedTransformerDecoder"),
    )
    input_cfg = InputConfig(
        pixel_mean=tuple(model.get("PIXEL_MEAN", (123.675, 116.28, 103.53))),
        pixel_std=tuple(model.get("PIXEL_STD", (58.395, 57.12, 57.375))),
        size_divisibility=mf.get("SIZE_DIVISIBILITY", 32),
    )
    test = raw.get("TEST", {})
    test_cfg = TestConfig(
        aug_enabled=_get(test, "AUG.ENABLED", False),
        aug_flip=_get(test, "AUG.FLIP", True),
        aug_min_sizes=tuple(_get(test, "AUG.MIN_SIZES", (512, 768, 1024, 1280, 1536, 1792))),
        aug_max_size=_get(test, "AUG.MAX_SIZE", 4096),
    )
    cfg = RbAConfig(
        backbone_name=backbone,
        sem_seg_head_name=head.get("NAME", "MaskFormerHead"),
        swin=swin,
        pixel_decoder=pixel_decoder,
        decoder=decoder,
        input=input_cfg,
        test=test_cfg,
        num_classes=head.get("NUM_CLASSES", 19),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def fast_serving(cfg: RbAConfig) -> RbAConfig:
    """``rba_tpu``'s fast serving mode (``rba_tpu/config.py`` ``fast_serving``): the pixel
    decoder's inputs in bf16, the bf16 window-attention softmax (``fast_math``), and the
    one-hot deformable sampling rounded to bf16, with its dispatch cap raised to 256M
    elements.  Norms, softmaxes, the sums of the sampling and the decoder stay fp32."""
    return dataclasses.replace(
        cfg,
        pixel_decoder_dtype="bfloat16",
        fast_math=True,
        pixel_decoder=dataclasses.replace(
            cfg.pixel_decoder,
            sampling_onehot_cap=256 * 1024 * 1024,
            sampling_dtype="bfloat16",
        ),
    )


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
