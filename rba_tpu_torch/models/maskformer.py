"""MaskFormer with the RbA score (counterpart of ``rba_tpu/models/maskformer.py``).

The serving path: ``preprocess`` → Swin → MSDeformAttn pixel decoder (fp32, or bf16
inputs under ``fast_serving``) → masked-attention decoder (fp32) → RbA tail.  ``maskformer_infer_rba`` hands the
decoder's ``bhwq`` masks to the fused RbA kernel, as the JAX package's TPU
branch does.  Its ``attention`` argument picks Swin's window-attention branch:
``"fused"`` (Kernel A, path 1), ``"fused_softmax"`` (Kernel C, path 2, which
with ``SwinConfig.mlp_impl="fused"`` also runs Kernel D) or ``"xla"`` (``rba_tpu``'s
default chain in plain PyTorch); see ``models/swin.py``.
``maskformer_infer_rba(..., plain=True)`` runs the plain PyTorch versions of
the kernels instead, which is how each path is held against them on the card.
Each layer of a request runs inside a ``torch.profiler.record_function`` span
named after it (``LAYERS``), so a profile of the entry reads its layers.
``build_model`` makes the model on the card unless told otherwise.  A model whose
config sets ``DecoderConfig.ood_prediction`` carries the DenseHybrid ``ood_pred``
head, which ``maskformer_infer`` returns.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ..config import RbAConfig, check_supported
from ..kernels.fused_rba import fused_rba_score, fused_rba_score_reference
from ..ops.resize import resize_bilinear
from .pixel_decoder import MSDeformAttn, PixelDecoder, pixel_decoder_apply
from .swin import Swin, swin_apply
from .transformer_decoder import MaskedDecoder, decoder_apply

# record_function spans of one request, in the order they run
LAYERS = ("preprocess", "backbone", "pixel_decoder", "transformer_decoder", "rba_tail")


class RbAModel(nn.Module):
    """Parameters of the whole model, named after the JAX pytree
    (``backbone``, ``sem_seg_head.pixel_decoder``, ``sem_seg_head.predictor``)."""

    def __init__(self, cfg: RbAConfig):
        super().__init__()
        check_supported(cfg)
        self.backbone = Swin(cfg.swin)
        self.sem_seg_head = nn.ModuleDict({
            "pixel_decoder": PixelDecoder(cfg.pixel_decoder, cfg.swin.out_channels),
            "predictor": MaskedDecoder(cfg.decoder, cfg.num_classes, cfg.pixel_decoder.conv_dim),
        })


def _trunc_normal(shape, gen, device, std=0.02):
    x = torch.randn(shape, generator=gen, device=device)
    out = x.abs() > 2.0
    while out.any():
        x[out] = torch.randn(int(out.sum()), generator=gen, device=device)
        out = x.abs() > 2.0
    return x * std


@torch.no_grad()
def init_params(model: RbAModel, seed: int) -> None:
    """Seeded random init after the JAX package's scheme: truncated normal (0.02) for
    the backbone's linears and bias tables, Xavier-uniform for other linears, He-normal
    convs, unit norms, normal embeddings, and the directional sampling-offset bias with
    zero offset and attention-weight projections."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for mname, mod in model.named_modules():
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
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
        if name.endswith("relative_position_bias_table"):
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
    plain: bool = False,
    attention: str = "fused",
) -> Dict:
    """pred_logits (B, Q, K+1) and pred_masks at stride 4, (B, Q, H/4, W/4) or
    (B, H/4, W/4, Q).  ``attention``: Swin's window-attention branch (``swin_apply``)."""
    check_supported(cfg)
    with record_function("backbone"):
        features = swin_apply(model.backbone, cfg.swin, images, _dtype(cfg.compute_dtype), plain=plain,
                              attention=attention, fast_math=cfg.fast_math)
    head = model.sem_seg_head
    with record_function("pixel_decoder"):
        mask_features, _, ms_feats = pixel_decoder_apply(head["pixel_decoder"], cfg.pixel_decoder, features,
                                                         _dtype(cfg.pixel_decoder_dtype))
    with record_function("transformer_decoder"):
        return decoder_apply(
            head["predictor"], cfg.decoder, ms_feats[: cfg.decoder.num_feature_levels], mask_features,
            final_mask_layout=final_mask_layout, need_aux=need_aux,
        )


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
    return images.to(next(model.parameters()).device)


@torch.inference_mode()
def maskformer_infer_rba(
    model: RbAModel,
    cfg: RbAConfig,
    images: torch.Tensor,  # (B, H, W, 3) raw RGB
    plain: bool = False,
    attention: str = "fused",
) -> torch.Tensor:  # (B, H, W) fp32
    """RbA score map: the full-resolution tail (x4 upsample → sigmoid → class
    contraction → -Σ tanh) runs as the fused RbA kernel on the decoder's bhwq masks,
    and the padding is cropped off.  Equal to ``maskformer_infer(...)["rba"]`` when the
    output size is the input size.  ``attention``: ``"fused"`` (Kernel A),
    ``"fused_softmax"`` (Kernel C) or ``"xla"``, Swin's window-attention branch."""
    images = _on_model(model, images)
    h_img, w_img = images.shape[1], images.shape[2]
    with record_function("preprocess"):
        x = preprocess(cfg, images)
    out = maskformer_forward(model, cfg, x, final_mask_layout="bhwq", plain=plain, attention=attention)
    score_fn = fused_rba_score_reference if plain else fused_rba_score
    with record_function("rba_tail"):
        rba = score_fn(out["pred_logits"], out["pred_masks"], masks_layout="bhwq")
        return rba[:, :h_img, :w_img]


@torch.inference_mode()
def maskformer_infer(
    model: RbAModel,
    cfg: RbAConfig,
    images: torch.Tensor,  # (B, H, W, 3) raw RGB
    out_hw: Optional[Tuple[int, int]] = None,
    include_void: bool = False,
    attention: str = "fused",
    plain: bool = False,
) -> Dict[str, torch.Tensor]:
    """{"sem_seg": (B, K, h, w), "rba": (B, h, w)} at ``out_hw`` (default: the input size),
    and for a model with the DenseHybrid head its (B, 2, H, W) ``ood_pred`` logits at the
    input size (resized with ``align_corners=True``, as the reference does).
    ``attention``: Swin's window-attention branch (``swin_apply``); ``plain`` runs the
    kernels' plain versions."""
    images = _on_model(model, images)
    h_img, w_img = images.shape[1], images.shape[2]
    out_hw = out_hw or (h_img, w_img)
    x = preprocess(cfg, images)
    hp, wp = x.shape[1], x.shape[2]
    out = maskformer_forward(model, cfg, x, attention=attention, plain=plain)
    mask_pred = resize_bilinear(out["pred_masks"], (hp, wp), align_corners=False)
    sem = semantic_inference(out["pred_logits"], mask_pred, include_void=include_void)
    sem = resize_bilinear(sem[:, :, :h_img, :w_img], out_hw, align_corners=False)
    result = {"sem_seg": sem, "rba": rba_score(sem)}
    if "ood_pred" in out:
        result["ood_pred"] = resize_bilinear(out["ood_pred"], (h_img, w_img), align_corners=True)
    return result
