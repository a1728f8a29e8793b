"""MaskFormer with the RbA score (counterpart of ``rba_tpu/models/maskformer.py``).

The serving path: ``preprocess`` → backbone (``models/backbones.py``: Swin, ResNet,
MiT, ViT, MViT or WiderResNet-38) → MSDeformAttn pixel decoder (fp32, or bf16 inputs
under ``fast_serving``) → masked-attention decoder (fp32) → RbA tail.  The other heads
(``models/baseline_heads.py``) plug in by name: the FPN pixel decoders, MaskFormer v1's
DETR decoder, the per-pixel and simple decoders of ``models/transformer_decoder.py``,
and the two per-pixel baseline heads, whose class logits ``per_pixel_forward`` returns
and ``maskformer_infer`` upsamples ×4 (no Kernel B: there is no (logits, masks) pair).
``maskformer_infer_rba`` hands the decoder's ``bhwq`` masks to the fused RbA kernel, as
the JAX package's TPU branch does, where the mask features are at stride 4 of the
padded input, the kernel's ×4 upsample.  A model whose mask features lie at another
stride (ViT at 16, WiderResNet-38 at 8) takes ``maskformer_infer(...)["rba"]``, which
resizes the masks to the padded input as the reference does; ``rba_tpu``'s fused tail
returns a map of the wrong size there (ROADMAP.md §C).  The ``attention`` argument
picks Swin's window-attention branch (MiT runs Kernel G in its attention cores, the
other backbones no kernel):
``"fused"`` (Kernel A, path 1), ``"fused_softmax"`` (Kernel C, path 2, which
with ``SwinConfig.mlp_impl="fused"`` also runs Kernel D) or ``"xla"`` (``rba_tpu``'s
default chain in plain PyTorch); see ``models/swin.py``.  Under
``kernels.plain_versions()`` every entry runs the kernels' plain PyTorch versions
instead, which is how each path is held against them on the card.
Each call of an entry is one ``request`` span, and inside it the frames' upload and
each layer run in spans named after them (``UPLOAD``, ``LAYERS``; ``utils/profiling.py``),
so a profile of the entry reads its layers.
Training calls ``maskformer_forward`` under autograd with ``need_aux=True`` and
``attention="xla"``, ``rba_tpu``'s training chain: Kernels A and C have no gradient and
refuse one, Kernel D steps aside when grad mode is on, and Swin runs without stochastic
depth, as ``rba_tpu``'s train step does (ROADMAP.md §C).
``build_model`` makes the model on the card unless told otherwise.  A model whose
config sets ``DecoderConfig.ood_prediction`` carries the DenseHybrid ``ood_pred``
head, which ``maskformer_infer`` returns.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import RbAConfig, check_supported
from ..kernels.fused_rba import fused_rba_score
from ..ops.resize import resize_bilinear
from ..utils.profiling import LAYERS  # noqa: F401  (the spans of a request's layers, read as maskformer.LAYERS)
from ..utils.profiling import REQUEST, UPLOAD, span
from . import baseline_heads as bh
from .backbones import backbone_apply, build_backbone
from .pixel_decoder import MSDeformAttn
from .swin import swin_apply
from .transformer_decoder import MaskedDecoder, SimpleDecoder, decoder_apply, simple_decoder_apply


class RbAModel(nn.Module):
    """Parameters of the whole model, named after the JAX pytree
    (``backbone``, ``sem_seg_head.pixel_decoder``, ``sem_seg_head.predictor``)."""

    def __init__(self, cfg: RbAConfig):
        super().__init__()
        check_supported(cfg)
        self.backbone = build_backbone(cfg)
        channels = self.backbone.out_channels
        self.sem_seg_head = nn.ModuleDict({
            "pixel_decoder": bh.build_pixel_decoder(cfg, channels), "predictor": _predictor(cfg, channels)})

    def mask_stride(self, cfg: RbAConfig) -> int:
        """The stride of the mask features: that of the pixel decoder's finest input."""
        return self.backbone.out_strides[cfg.pixel_decoder.in_features[0]]


def _predictor(cfg: RbAConfig, channels: Dict[str, int]) -> nn.Module:
    """The predictor of ``SEM_SEG_HEAD.NAME`` and, in ``MaskFormerHead``, of
    ``TRANSFORMER_DECODER_NAME``."""
    d = cfg.decoder
    if cfg.sem_seg_head_name == "PerPixelBaselineHead":
        return nn.Conv2d(cfg.pixel_decoder.mask_dim, cfg.num_classes, 1)
    if cfg.sem_seg_head_name == "PerPixelBaselinePlusHead":
        return bh.StandardDecoder(cfg, bh.plus_predictor_in_channels(cfg, channels), mask_classification=False)
    if d.name == "StandardTransformerDecoder":
        return bh.StandardDecoder(cfg, bh.plus_predictor_in_channels(cfg, channels))
    if d.name in ("SimpleDecoder", "SimpleTransformerDecoder"):
        return SimpleDecoder(d, cfg.num_classes)
    return MaskedDecoder(d, cfg.num_classes, cfg.pixel_decoder.conv_dim,
                         mask_classification=d.name != "MultiScalePerPixelDecoder")


def is_per_pixel(cfg: RbAConfig) -> bool:
    """A per-pixel baseline head: class logits per pixel, no (logits, masks) pair."""
    return cfg.sem_seg_head_name != "MaskFormerHead"


def _trunc_normal(shape, gen, device, std=0.02):
    x = torch.randn(shape, generator=gen, device=device)
    out = x.abs() > 2.0
    while out.any():
        x[out] = torch.randn(int(out.sum()), generator=gen, device=device)
        out = x.abs() > 2.0
    return x * std


@torch.no_grad()
def init_norm_(norm: nn.Module) -> nn.Module:
    """The init of every LayerNorm and GroupNorm in ``init_params``: unit scale, zero bias."""
    norm.weight.fill_(1.0)
    norm.bias.zero_()
    return norm


@torch.no_grad()
def init_params(model: RbAModel, seed: int) -> None:
    """Seeded random init after the JAX package's scheme: truncated normal (0.02) for
    the backbone's linears, bias and position tables, Xavier-uniform for other linears,
    He-normal convs, unit norms, normal embeddings, and the directional sampling-offset
    bias with zero offset and attention-weight projections.  Batch norms keep unit
    scale and variance, zero bias and mean."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for mname, mod in model.named_modules():
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            init_norm_(mod)
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen, device=device) * math.sqrt(2.0 / fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            if mname.startswith("backbone."):
                mod.weight.copy_(_trunc_normal(mod.weight.shape, gen, device))
            else:
                fan_out, fan_in = mod.weight.shape
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.copy_((torch.rand(mod.weight.shape, generator=gen, device=device) * 2 - 1) * limit)
            if mod.bias is not None:
                mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(torch.as_tensor(mod.offset_bias_grid(), device=device))
            mod.attention_weights.weight.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("relative_position_bias_table", "pos_embed", "rel_pos_h", "rel_pos_w")):
            p.copy_(_trunc_normal(p.shape, gen, device))
        elif name.endswith(("level_embed", "query_feat", "query_embed")):
            p.copy_(torch.randn(p.shape, generator=gen, device=device))


def resolve_device(device, what: str):
    """``device``, or the card where it is None; raises where there is no GPU to default to."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the GPU by default and none is available; "
                           "pass device='cpu' to run on the CPU")
    return "cuda"


def build_model(cfg: RbAConfig, device=None, seed: int = 0) -> RbAModel:
    """The model with seeded random weights on ``device``, the card by default.  Raises
    where there is no GPU and no device is given."""
    device = resolve_device(device, "build_model")
    check_supported(cfg)
    with torch.device(device):
        model = RbAModel(cfg)
    init_params(model, seed)
    return model.eval()


def _dtype(name: str):
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def preprocess(cfg: RbAConfig, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) raw RGB [0, 255] → normalized fp32, zero-padded at the bottom and
    right to ``size_divisibility``."""
    mean = torch.tensor(cfg.input.pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg.input.pixel_std, dtype=torch.float32, device=images.device)
    x = (images.float() - mean) / std
    div = cfg.input.size_divisibility
    if div > 0:
        h, w = x.shape[1], x.shape[2]
        ph, pw = (div - h % div) % div, (div - w % div) % div
        if ph or pw:
            x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    return x


def maskformer_forward(
    model: RbAModel,
    cfg: RbAConfig,
    images: torch.Tensor,  # (B, Hp, Wp, 3) normalized and padded
    final_mask_layout: str = "bqhw",
    need_aux: bool = False,
    attention: str = "fused",
) -> Dict:
    """pred_logits (B, Q, K+1) and pred_masks at the mask features' stride s (4 but for
    ViT and WiderResNet-38), (B, Q, H/s, W/s) or (B, H/s, W/s, Q), with ``aux_outputs``
    under ``need_aux``, by ``TRANSFORMER_DECODER_NAME``: ``MultiScalePerPixelDecoder``
    has no class head and always returns its full-resolution ``aux_outputs``, as
    ``rba_tpu`` computes them; the v1 decoder's ``aux_outputs`` follow
    ``cfg.loss.deep_supervision`` under ``need_aux``.  ``attention``: Swin's
    window-attention branch (``swin_apply``).  A per-pixel head takes ``per_pixel_forward``."""
    if is_per_pixel(cfg):
        raise ValueError(f"{cfg.sem_seg_head_name} has no mask predictions; call per_pixel_forward")
    features = _backbone_features(model, cfg, images, attention)
    with span("pixel_decoder"):
        mask_features, enc_feat, ms_feats = bh.pixel_decoder_apply(model.sem_seg_head["pixel_decoder"], cfg,
                                                                   features, _dtype(cfg.pixel_decoder_dtype))
    pred, d = model.sem_seg_head["predictor"], cfg.decoder
    with span("transformer_decoder"):
        if isinstance(pred, bh.StandardDecoder):
            x = bh.standard_decoder_input(cfg, features, mask_features, enc_feat)
            return bh.standard_decoder_apply(pred, cfg, x, mask_features, final_mask_layout=final_mask_layout,
                                             deep_supervision=need_aux and cfg.loss.deep_supervision)
        if isinstance(pred, SimpleDecoder):
            return simple_decoder_apply(pred, d, mask_features, final_mask_layout=final_mask_layout)
        return decoder_apply(pred, d, ms_feats[: d.num_feature_levels], mask_features,
                             final_mask_layout=final_mask_layout, need_aux=need_aux or pred.class_embed is None)


def _backbone_features(model: RbAModel, cfg: RbAConfig, images, attention: str):
    check_supported(cfg)
    with span("backbone"):
        if cfg.backbone_name == "swin":
            return swin_apply(model.backbone, cfg.swin, images, _dtype(cfg.compute_dtype), attention=attention,
                              fast_math=cfg.fast_math)
        return backbone_apply(model.backbone, cfg, images, _dtype(cfg.compute_dtype))


def per_pixel_forward(
    model: RbAModel,
    cfg: RbAConfig,
    images: torch.Tensor,  # (B, Hp, Wp, 3) normalized and padded
    attention: str = "fused",
):
    """A per-pixel head's ((B, K, Hp/4, Wp/4) class logits, aux list of {"pred_masks"}):
    the Plus head's earlier decoder layers, none for the plain head."""
    if not is_per_pixel(cfg):
        raise ValueError("per_pixel_forward takes a per-pixel baseline head")
    features = _backbone_features(model, cfg, images, attention)
    head = model.sem_seg_head
    with span("pixel_decoder"):
        mask_features, enc_feat, _ = bh.pixel_decoder_apply(head["pixel_decoder"], cfg, features,
                                                            _dtype(cfg.pixel_decoder_dtype))
    with span("transformer_decoder"):  # the predictor
        return bh.per_pixel_predict(head["predictor"], cfg, features, mask_features, enc_feat)


def semantic_inference(
    mask_cls: torch.Tensor,  # (B, Q, K+1)
    mask_pred: torch.Tensor,  # (B, Q, H, W)
    include_void: bool = False,
) -> torch.Tensor:  # (B, K, H, W)
    """softmax over classes (no-object dropped unless ``include_void``) ⊗ sigmoid masks."""
    cls = torch.softmax(mask_cls.float(), dim=-1)
    if not include_void:
        cls = cls[..., :-1]
    return torch.einsum("bqc,bqhw->bchw", cls, torch.sigmoid(mask_pred.float()))


def rba_score(sem_seg: torch.Tensor) -> torch.Tensor:
    """RbA outlier score: -Σ_k tanh(logit_k) over the class axis."""
    return -torch.tanh(sem_seg.float()).sum(dim=-3)


def energy_score(sem_seg: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Energy (PEBAL) outlier score: -T·logsumexp(logit_k / T) over the class axis."""
    return -temperature * torch.logsumexp(sem_seg.float() / temperature, dim=-3)


def _on_model(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The frames on the model's device: their upload, in the ``upload`` span."""
    with span(UPLOAD):
        return images.to(next(model.parameters()).device)


@torch.inference_mode()
def maskformer_infer_rba(
    model: RbAModel,
    cfg: RbAConfig,
    images: torch.Tensor,  # (B, H, W, 3) raw RGB
    attention: str = "fused",
) -> torch.Tensor:  # (B, H, W) fp32
    """RbA score map: the full-resolution tail (x4 upsample → sigmoid → class
    contraction → -Σ tanh) runs as the fused RbA kernel on the decoder's bhwq masks,
    and the padding is cropped off.  Equal to ``maskformer_infer(...)["rba"]`` when the
    output size is the input size.  A model whose mask features are not at stride 4
    returns ``maskformer_infer(...)["rba"]`` itself, without the kernel.  ``attention``:
    ``"fused"`` (Kernel A), ``"fused_softmax"`` (Kernel C) or ``"xla"``, Swin's
    window-attention branch.  The call is one ``request`` span."""
    with span(REQUEST):
        if model.mask_stride(cfg) != 4 or is_per_pixel(cfg):
            return _infer(model, cfg, images, None, False, attention)["rba"]
        images = _on_model(model, images)
        h_img, w_img = images.shape[1], images.shape[2]
        with span("preprocess"):
            x = preprocess(cfg, images)
        out = maskformer_forward(model, cfg, x, final_mask_layout="bhwq", attention=attention)
        if "pred_logits" not in out:
            raise ValueError(f"{cfg.decoder.name} has no class head to score with (ROADMAP.md §C.18)")
        with span("rba_tail"):
            rba = fused_rba_score(out["pred_logits"], out["pred_masks"], masks_layout="bhwq")
            return rba[:, :h_img, :w_img]


@torch.inference_mode()
def maskformer_infer(
    model: RbAModel,
    cfg: RbAConfig,
    images: torch.Tensor,  # (B, H, W, 3) raw RGB
    out_hw: Optional[Tuple[int, int]] = None,
    include_void: bool = False,
    attention: str = "fused",
) -> Dict[str, torch.Tensor]:
    """{"sem_seg": (B, K, h, w), "rba": (B, h, w)} at ``out_hw`` (default: the input size),
    and for a model with the DenseHybrid head its (B, 2, H, W) ``ood_pred`` logits at the
    input size (resized with ``align_corners=True``, as the reference does).
    ``attention``: Swin's window-attention branch (``swin_apply``).  The call is one
    ``request`` span (so each variant of a TTA and each tile of a sliding window is one)."""
    with span(REQUEST):
        return _infer(model, cfg, images, out_hw, include_void, attention)


def _infer(model: RbAModel, cfg: RbAConfig, images: torch.Tensor, out_hw: Optional[Tuple[int, int]],
           include_void: bool, attention: str) -> Dict[str, torch.Tensor]:
    """``maskformer_infer`` inside its caller's ``request`` span."""
    images = _on_model(model, images)
    h_img, w_img = images.shape[1], images.shape[2]
    out_hw = out_hw or (h_img, w_img)
    with span("preprocess"):
        x = preprocess(cfg, images)
    hp, wp = x.shape[1], x.shape[2]
    if is_per_pixel(cfg):  # logits upsampled ×4 to the padded input, cropped, resized
        logits, _ = per_pixel_forward(model, cfg, x, attention=attention)
        with span("rba_tail"):
            sem = resize_bilinear(resize_bilinear(logits, (hp, wp))[:, :, :h_img, :w_img], out_hw)
            return {"sem_seg": sem, "rba": rba_score(sem)}
    out = maskformer_forward(model, cfg, x, attention=attention)
    if "pred_logits" not in out:
        raise ValueError(f"{cfg.decoder.name} has no class head to infer with (ROADMAP.md §C.18)")
    with span("rba_tail"):
        mask_pred = resize_bilinear(out["pred_masks"], (hp, wp), align_corners=False)
        sem = semantic_inference(out["pred_logits"], mask_pred, include_void=include_void)
        sem = resize_bilinear(sem[:, :, :h_img, :w_img], out_hw, align_corners=False)
        result = {"sem_seg": sem, "rba": rba_score(sem)}
    if "ood_pred" in out:
        result["ood_pred"] = resize_bilinear(out["ood_pred"], (h_img, w_img), align_corners=True)
    return result
