"""Configuration of the PyTorch port: the fields its models, evaluations and trainer read.

A copy, not an import, of the dataclasses of ``rba_tpu/config.py`` and of its
presets.  Field names and defaults are the same, so a config of one package can be
rebuilt field by field in the other; ``check_supported`` refuses a name that no registry
holds.  ``load_d2_config`` reads a Detectron2
``config.yaml`` (with its ``_BASE_`` chain) into these fields, with the values
``rba_tpu.config.load_d2_config`` gives them; ``load_config`` also reads the native
format that ``save_config`` writes (``config_to_dict``: the fields that differ from
the defaults).
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
    drop_path_rate: float = 0.3  # read, and not applied: rba_tpu's train step runs no stochastic depth
    pretrain_img_size: int = 384
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    use_checkpoint: bool = False  # rematerialise each block under autograd (torch.utils.checkpoint)
    # "partition"; rba_tpu's TPU lowerings of its function ("nested", "resident",
    # "qkv_canvas", "proj_canvas") run the partition layout in the port (models/swin.py)
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
    dec_layers_total: int = 6  # MASK_FORMER.DEC_LAYERS as written (the v1 decoder's)
    enc_layers: int = 0
    pre_norm: bool = False
    mask_dim: int = 256
    enforce_input_project: bool = False
    num_feature_levels: int = 1
    ood_prediction: bool = False
    name: str = "MultiScaleMaskedTransformerDecoder"
    transformer_in_feature: str = "multi_scale_pixel_decoder"


@dataclass(frozen=True)
class ResNetConfig:
    """Detectron2's ResNet (``MODEL.RESNETS``).  Every depth is built of bottlenecks, as
    the JAX package builds it; its batch norms run as frozen ones whatever ``norm`` says."""
    depth: int = 50
    stem_out_channels: int = 64
    stride_in_1x1: bool = False
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    norm: str = "SyncBN"

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[self.depth]

    @property
    def out_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": 256 * 2**i for i in range(4)}


@dataclass(frozen=True)
class InputConfig:
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    size_divisibility: int = 32
    min_size_test: int = 1024
    max_size_test: int = 2048
    image_format: str = "RGB"
    # the training mapper's fields (Detectron2's INPUT.*)
    min_size_train: Tuple[int, ...] = tuple(int(x * 0.1 * 1024) for x in range(5, 21))
    max_size_train: int = 4096
    crop_enabled: bool = True
    crop_size: Tuple[int, int] = (512, 1024)
    single_category_max_area: float = 1.0
    color_aug_ssd: bool = True
    random_flip: bool = True
    train_size_divisibility: int = -1  # INPUT.SIZE_DIVISIBILITY (-1: pad to the crop)
    dataset_mapper_name: str = "mask_former_semantic"
    repeat_instance_masks: int = 1
    coco_root: str = "coco/"  # INPUT.COCO_ROOT, relative to the datasets directory
    coco_proxy_size: int = 300
    # the COCO large-scale-jitter geometry (INPUT.IMAGE_SIZE / MIN_SCALE / MAX_SCALE)
    image_size: int = 1024
    min_scale: float = 0.1
    max_scale: float = 2.0


@dataclass(frozen=True)
class TestConfig:
    """What an evaluation computes (``MODEL.MASK_FORMER.TEST``: the semantic, panoptic and
    instance outputs and the panoptic thresholds), and test-time augmentation
    (Detectron2's ``TEST.AUG``): the shortest edge resized to each of ``aug_min_sizes``
    (the longest capped at ``aug_max_size``), each also flipped horizontally when
    ``aug_flip``."""
    semantic_on: bool = True
    panoptic_on: bool = False
    instance_on: bool = False
    sem_seg_postprocessing_before_inference: bool = False
    object_mask_threshold: float = 0.8
    overlap_threshold: float = 0.8
    aug_enabled: bool = False
    aug_flip: bool = True
    aug_min_sizes: Tuple[int, ...] = (512, 768, 1024, 1280, 1536, 1792)
    aug_max_size: int = 4096
    eval_period: int = 5000  # TEST.EVAL_PERIOD (0: no evaluation during training)


@dataclass(frozen=True)
class OODConfig:
    """The outlier-exposure settings of RbA's fine-tuning."""
    ood_label: int = 254
    ood_prob: float = 0.2
    outlier_supervision: bool = False
    outlier_loss_target: str = "none"
    score_norm: str = "none"
    outlier_loss_func: str = "max"
    inlier_upper_threshold: float = 0.0
    outlier_lower_threshold: float = 5.0
    outlier_weight: float = 1.0
    smoothness_loss: bool = False
    smoothness_score: str = "none"
    smoothness_weight: float = 3.0e-6
    sparsity_loss: bool = False
    sparsity_weight: float = 5.0e-4
    gambler_loss: bool = False
    gambler_weight: float = 1.0
    ood_reg: float = 0.1
    pebal_reward: float = 4.5
    densehybrid_loss: bool = False
    densehybrid_beta: float = 0.03
    densehybrid_weight: float = 1.0


@dataclass(frozen=True)
class LossConfig:
    """The criterion's weights, point sampling and matcher."""
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    deep_supervision: bool = True
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    matcher: str = "HungarianMatcher"
    use_point_rend: bool = False


@dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 1e-4
    weight_decay: float = 0.05
    weight_decay_embed: float = 0.0
    weight_decay_norm: float = 0.0
    backbone_multiplier: float = 0.1
    clip_gradients: bool = True
    clip_value: float = 0.01
    max_iter: int = 90000
    warmup_iters: int = 0
    warmup_factor: float = 1.0
    poly_lr_power: float = 0.9
    poly_lr_constant_ending: float = 0.0
    ims_per_batch: int = 16
    amp: bool = True
    num_workers: int = 4  # DATALOADER.NUM_WORKERS: the trainer's mapper threads
    freeze_backbone: bool = False
    freeze_pixel_decoder: bool = False
    freeze_transformer_decoder: bool = False
    # read as rba_tpu reads them, and ignored as it ignores them (ROADMAP.md §C)
    freeze_transformer_decoder_except_mlp: bool = False
    freeze_transformer_decoder_except_object_queries: bool = False


@dataclass(frozen=True)
class RbAConfig:
    backbone_name: str = "swin"
    sem_seg_head_name: str = "MaskFormerHead"
    swin: SwinConfig = field(default_factory=SwinConfig)
    resnet: ResNetConfig = field(default_factory=ResNetConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    test: TestConfig = field(default_factory=TestConfig)
    input: InputConfig = field(default_factory=InputConfig)
    ood: OODConfig = field(default_factory=OODConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    num_classes: int = 19
    # DATASETS.TRAIN / DATASETS.TEST names and DATASETS.UNSEEN_LABEL_SET
    datasets_train: Tuple[str, ...] = ("cityscapes_fine_sem_seg_train",)
    datasets_test: Tuple[str, ...] = ("cityscapes_fine_sem_seg_val",)
    unseen_label_set: str = ""
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pixel_decoder_dtype: str = "float32"
    fast_math: bool = False
    weight_quant: str = "none"

    @property
    def sem_seg_head_ignore_value(self) -> int:
        return 255


# the backbone families the port runs (models/backbones.py)
BACKBONES = ("swin", "resnet", "mix_transformer", "mit_b0", "mit_b1", "mit_b2", "mit_b3", "mit_b4", "mit_b5",
             "vit", "vit_sfp", "mvit", "wideresnet38")


# the registries' names (SEM_SEG_HEAD.NAME, PIXEL_DECODER_NAME, TRANSFORMER_DECODER_NAME)
HEADS = ("MaskFormerHead", "PerPixelBaselineHead", "PerPixelBaselinePlusHead")
PIXEL_DECODERS = ("MSDeformAttnPixelDecoder", "BasePixelDecoder", "TransformerEncoderPixelDecoder")
DECODERS = ("MultiScaleMaskedTransformerDecoder", "MultiScalePerPixelDecoder", "SimpleDecoder",
            "SimpleTransformerDecoder", "StandardTransformerDecoder")


# rba_tpu's window-attention lowerings, each optionally per stage ("resident:0,1")
ATTN_LAYOUTS = ("partition", "nested", "resident", "qkv_canvas", "proj_canvas")
SAMPLING_METHODS = ("auto", "gather", "onehot", "gather_scatter")


def check_supported(cfg: RbAConfig) -> None:
    """Raise ``NotImplementedError`` for a name that no registry holds, as ``rba_tpu``
    raises.  Every option ``rba_tpu`` runs is taken: ``pixel_decoder.norm`` is read and
    GroupNorm runs whatever it says, as in ``rba_tpu``; no model reads ``param_dtype``;
    ``sampling_method="gather_scatter"`` is the gather's function; every
    ``attn_layout`` runs the partition layout (``models/swin.py``)."""
    unknown = {
        f"backbone {cfg.backbone_name!r}": cfg.backbone_name not in BACKBONES,
        f"SEM_SEG_HEAD.NAME {cfg.sem_seg_head_name!r}": cfg.sem_seg_head_name not in HEADS,
        f"PIXEL_DECODER_NAME {cfg.pixel_decoder.name!r}": cfg.pixel_decoder.name not in PIXEL_DECODERS,
        f"TRANSFORMER_DECODER_NAME {cfg.decoder.name!r}": cfg.decoder.name not in DECODERS,
        f"Swin attn_layout={cfg.swin.attn_layout!r}": cfg.swin.attn_layout.split(":")[0] not in ATTN_LAYOUTS,
        f"Swin mlp_impl={cfg.swin.mlp_impl!r}": cfg.swin.mlp_impl not in ("xla", "fused"),
        f"weight_quant={cfg.weight_quant!r}": cfg.weight_quant not in ("none", "int8"),
        f"sampling_method={cfg.pixel_decoder.sampling_method!r}":
            cfg.pixel_decoder.sampling_method not in SAMPLING_METHODS,
    }
    missing = [name for name, hit in unknown.items() if hit]
    if missing:
        raise NotImplementedError("not in the registries: " + ", ".join(missing))
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


def _strs(v) -> Tuple[str, ...]:
    """A string sequence: a YAML list, or the CfgNode tuple literal ``("a",)`` that YAML
    reads as a string."""
    if isinstance(v, str):
        if not v.lstrip().startswith(("(", "[")):
            return (v,)
        import ast

        v = ast.literal_eval(v)
    return tuple(str(x) for x in v)


def _seq(v) -> Tuple[int, ...]:
    """An int sequence: a YAML list, a scalar, or the CfgNode tuple literal ``(512, 1024)``
    that YAML reads as a string."""
    if isinstance(v, str):
        import ast

        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        v = (v,)
    return tuple(int(x) for x in v)


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
    ``rba_tpu.config.load_d2_config`` reads it; a backbone or head that no registry
    holds loads and is refused by ``check_supported``."""
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
        drop_path_rate=swin_raw.get("DROP_PATH_RATE", 0.3),
        pretrain_img_size=swin_raw.get("PRETRAIN_IMG_SIZE", 384),
        out_features=tuple(swin_raw.get("OUT_FEATURES", ("res2", "res3", "res4", "res5"))),
        use_checkpoint=swin_raw.get("USE_CHECKPOINT", False),
    )
    resnet_raw = model.get("RESNETS", {})
    resnet = ResNetConfig(
        depth=resnet_raw.get("DEPTH", 50),
        stem_out_channels=resnet_raw.get("STEM_OUT_CHANNELS", 64),
        stride_in_1x1=resnet_raw.get("STRIDE_IN_1X1", False),
        out_features=tuple(resnet_raw.get("OUT_FEATURES", ("res2", "res3", "res4", "res5"))),
        norm=resnet_raw.get("NORM", "SyncBN"),
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
        dec_layers_total=_int(mf.get("DEC_LAYERS", 6), 6),
        enc_layers=_int(mf.get("ENC_LAYERS", 0), 0),
        pre_norm=mf.get("PRE_NORM", False),
        mask_dim=head.get("MASK_DIM", 256),
        enforce_input_project=mf.get("ENFORCE_INPUT_PROJ", False),
        num_feature_levels=len(head.get("DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES", ("res5",))),
        ood_prediction=mf.get("DENSE_HYBRID_LOSS", False),
        name=mf.get("TRANSFORMER_DECODER_NAME", "MultiScaleMaskedTransformerDecoder"),
        transformer_in_feature=mf.get("TRANSFORMER_IN_FEATURE", "res5"),
    )
    inp = raw.get("INPUT", {})
    crop = inp.get("CROP", {})
    mst = inp.get("MIN_SIZE_TRAIN", tuple(int(x * 0.1 * 1024) for x in range(5, 21)))
    input_cfg = InputConfig(
        pixel_mean=tuple(model.get("PIXEL_MEAN", (123.675, 116.28, 103.53))),
        pixel_std=tuple(model.get("PIXEL_STD", (58.395, 57.12, 57.375))),
        size_divisibility=mf.get("SIZE_DIVISIBILITY", 32),
        min_size_test=inp.get("MIN_SIZE_TEST", 1024),
        max_size_test=inp.get("MAX_SIZE_TEST", 2048),
        image_format=inp.get("FORMAT", "RGB"),
        min_size_train=_seq(mst),
        max_size_train=inp.get("MAX_SIZE_TRAIN", 4096),
        crop_enabled=crop.get("ENABLED", True),
        crop_size=_seq(crop.get("SIZE", (512, 1024))),
        single_category_max_area=crop.get("SINGLE_CATEGORY_MAX_AREA", 1.0),
        color_aug_ssd=inp.get("COLOR_AUG_SSD", True),
        random_flip=inp.get("RANDOM_FLIP", "horizontal") != "none",
        train_size_divisibility=inp.get("SIZE_DIVISIBILITY", -1),
        dataset_mapper_name=inp.get("DATASET_MAPPER_NAME", "mask_former_semantic"),
        repeat_instance_masks=inp.get("REPEAT_INSTANCE_MASKS", 1),
        coco_root=inp.get("COCO_ROOT", "coco/"),
        coco_proxy_size=inp.get("COCO_PROXY_SIZE", 300),
        image_size=inp.get("IMAGE_SIZE", 1024),
        min_scale=inp.get("MIN_SCALE", 0.1),
        max_scale=inp.get("MAX_SCALE", 2.0),
    )
    test = raw.get("TEST", {})
    tst = mf.get("TEST", {})
    test_cfg = TestConfig(
        semantic_on=tst.get("SEMANTIC_ON", True),
        panoptic_on=tst.get("PANOPTIC_ON", False),
        instance_on=tst.get("INSTANCE_ON", False),
        sem_seg_postprocessing_before_inference=tst.get("SEM_SEG_POSTPROCESSING_BEFORE_INFERENCE", False),
        object_mask_threshold=tst.get("OBJECT_MASK_THRESHOLD", 0.8),
        overlap_threshold=tst.get("OVERLAP_THRESHOLD", 0.8),
        aug_enabled=_get(test, "AUG.ENABLED", False),
        aug_flip=_get(test, "AUG.FLIP", True),
        aug_min_sizes=tuple(_get(test, "AUG.MIN_SIZES", (512, 768, 1024, 1280, 1536, 1792))),
        aug_max_size=_get(test, "AUG.MAX_SIZE", 4096),
        eval_period=_get(test, "EVAL_PERIOD", 5000),
    )
    ood = OODConfig(
        ood_label=inp.get("OOD_LABEL", 254),
        ood_prob=inp.get("OOD_PROB", 0.2),
        outlier_supervision=mf.get("OUTLIER_SUPERVISION", False),
        outlier_loss_target=mf.get("OUTLIER_LOSS_TARGET", "none"),
        score_norm=mf.get("SCORE_NORM", "none"),
        outlier_loss_func=mf.get("OUTLIER_LOSS_FUNC", "max"),
        inlier_upper_threshold=mf.get("INLIER_UPPER_THRESHOLD", 0.0),
        outlier_lower_threshold=mf.get("OUTLIER_LOWER_THRESHOLD", 5.0),
        outlier_weight=mf.get("OUTLIER_WEIGHT", 1.0),
        smoothness_loss=mf.get("SMOOTHNESS_LOSS", False),
        smoothness_score=mf.get("SMOOTHNESS_SCORE", "none"),
        smoothness_weight=mf.get("SMOOTHNESS_WEIGHT", 3.0e-6),
        sparsity_loss=mf.get("SPARSITY_LOSS", False),
        sparsity_weight=mf.get("SPARSITY_WEIGHT", 5.0e-4),
        gambler_loss=mf.get("GAMBLER_LOSS", False),
        gambler_weight=mf.get("GAMBLER_WEIGHT", 1.0),
        ood_reg=mf.get("PEBAL_OOD_REG", 0.1),
        pebal_reward=mf.get("PEBAL_REWARD", 4.5),
        densehybrid_loss=mf.get("DENSE_HYBRID_LOSS", False),
        densehybrid_beta=mf.get("DENSE_HYBRID_BETA", 0.03),
        densehybrid_weight=mf.get("DENSE_HYBRID_WEIGHT", 1.0),
    )
    loss = LossConfig(
        class_weight=mf.get("CLASS_WEIGHT", 2.0),
        mask_weight=mf.get("MASK_WEIGHT", 5.0),
        dice_weight=mf.get("DICE_WEIGHT", 5.0),
        no_object_weight=mf.get("NO_OBJECT_WEIGHT", 0.1),
        deep_supervision=mf.get("DEEP_SUPERVISION", True),
        train_num_points=mf.get("TRAIN_NUM_POINTS", 12544),
        oversample_ratio=mf.get("OVERSAMPLE_RATIO", 3.0),
        importance_sample_ratio=mf.get("IMPORTANCE_SAMPLE_RATIO", 0.75),
        matcher=mf.get("MATCHER", "HungarianMatcher"),
        use_point_rend=mf.get("USE_POINT_REND", False),
    )
    solver = raw.get("SOLVER", {})
    solver_cfg = SolverConfig(
        base_lr=solver.get("BASE_LR", 1e-4),
        weight_decay=solver.get("WEIGHT_DECAY", 0.05),
        weight_decay_embed=solver.get("WEIGHT_DECAY_EMBED", 0.0),
        weight_decay_norm=solver.get("WEIGHT_DECAY_NORM", 0.0),
        backbone_multiplier=solver.get("BACKBONE_MULTIPLIER", 0.1),
        clip_gradients=_get(solver, "CLIP_GRADIENTS.ENABLED", True),
        clip_value=_get(solver, "CLIP_GRADIENTS.CLIP_VALUE", 0.01),
        max_iter=solver.get("MAX_ITER", 90000),
        warmup_iters=solver.get("WARMUP_ITERS", 0),
        warmup_factor=solver.get("WARMUP_FACTOR", 1.0),
        poly_lr_power=solver.get("POLY_LR_POWER", 0.9),
        poly_lr_constant_ending=solver.get("POLY_LR_CONSTANT_ENDING", 0.0),
        ims_per_batch=solver.get("IMS_PER_BATCH", 16),
        amp=_get(solver, "AMP.ENABLED", True),
        num_workers=_get(raw, "DATALOADER.NUM_WORKERS", 4),
        freeze_backbone=model.get("FREEZE_BACKBONE", False),
        freeze_pixel_decoder=model.get("FREEZE_PIXEL_DECODER", False),
        freeze_transformer_decoder=model.get("FREEZE_TRANSFORMER_DECODER", False),
        freeze_transformer_decoder_except_mlp=model.get("FREEZE_TRANSFORMER_DECODER_EXCEPT_MLP", False),
        freeze_transformer_decoder_except_object_queries=model.get(
            "FREEZE_TRANSFORMER_DECODER_EXCEPT_OBJECT_QUERIES", False),
    )
    ds_raw = raw.get("DATASETS", {})
    cfg = RbAConfig(
        backbone_name=backbone,
        sem_seg_head_name=head.get("NAME", "MaskFormerHead"),
        swin=swin,
        resnet=resnet,
        pixel_decoder=pixel_decoder,
        decoder=decoder,
        input=input_cfg,
        test=test_cfg,
        ood=ood,
        loss=loss,
        solver=solver_cfg,
        num_classes=head.get("NUM_CLASSES", 19),
        datasets_train=_strs(ds_raw.get("TRAIN", ("cityscapes_fine_sem_seg_train",))),
        datasets_test=_strs(ds_raw.get("TEST", ("cityscapes_fine_sem_seg_val",))),
        unseen_label_set=ds_raw.get("UNSEEN_LABEL_SET", ""),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def config_to_dict(cfg: RbAConfig) -> Dict[str, Any]:
    """The native format: a nested dict of the fields that differ from ``RbAConfig()``,
    tuples as lists."""

    def diff(obj, ref):
        out = {}
        for f in dataclasses.fields(obj):
            v, r = getattr(obj, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(v):
                sub = diff(v, r)
                if sub:
                    out[f.name] = sub
            elif v != r:
                out[f.name] = list(v) if isinstance(v, tuple) else v
        return out

    return diff(cfg, RbAConfig())


def config_from_dict(d: Dict[str, Any]) -> RbAConfig:
    """The inverse of ``config_to_dict``: missing keys keep their defaults."""

    def build(cls, sub: Dict[str, Any]):
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for k, v in sub.items():
            f = fields[k]
            if isinstance(v, dict):
                base = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
                kwargs[k] = build(type(base), v)
            else:
                kwargs[k] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)

    return build(RbAConfig, d)


def save_config(path: str, cfg: RbAConfig) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=True)


def load_config(path: str, **overrides) -> RbAConfig:
    """A native YAML (``save_config``'s format) or a Detectron2 one, which has a ``MODEL``
    section or a ``_BASE_`` chain."""
    import yaml

    with open(path) as f:
        raw = yaml.load(f, Loader=_d2_yaml_loader()) or {}
    if "MODEL" in raw or "_BASE_" in raw:
        return load_d2_config(path, **overrides)
    cfg = config_from_dict(raw)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


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
