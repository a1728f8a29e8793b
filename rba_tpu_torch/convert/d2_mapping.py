"""Detectron2 checkpoint → parameter-pytree conversion (a copy of ``rba_tpu/convert/d2_mapping.py``
for the families the port runs).

Takes a released ``model_final.pth`` state dict (numpy arrays under Detectron2's
names) to the JAX package's pytree, leaf for leaf the tree ``rba_tpu`` produces;
``load_jax_params`` then copies it into the port's model.

  * historical renames the reference applies at load:
      - ``static_query`` → ``query_feat``
      - bare ``sem_seg_head.*`` (outside the predictor) → ``sem_seg_head.pixel_decoder.*``
  * layout transposes: Linear (out, in) → (in, out); Conv OIHW → HWIO;
    MultiheadAttention in_proj (3C, C) → (C, 3C)
  * the fused qkv stays fused
  * ``relative_position_index`` and other buffers are dropped: the model
    regenerates them

Families the port has no model for (backbones other than Swin, the FPN pixel
decoders, the standard and per-pixel heads) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import RbAConfig

_LATER = "is not ported yet (ROADMAP.md §A.6, other heads and backbones)"


def _t(w):  # linear transpose
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):  # OIHW -> HWIO
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def apply_historical_renames(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        nk = k
        if "static_query" in nk:
            nk = nk.replace("static_query", "query_feat")
        if nk.startswith("sem_seg_head.") and not nk.startswith(
            ("sem_seg_head.predictor", "sem_seg_head.pixel_decoder")
        ):
            nk = nk.replace("sem_seg_head.", "sem_seg_head.pixel_decoder.", 1)
        out[nk] = v
    return out


def _ln(sd, prefix):
    return {"scale": np.asarray(sd[prefix + ".weight"]), "bias": np.asarray(sd[prefix + ".bias"])}


def _linear(sd, prefix, bias=True):
    p = {"kernel": _t(sd[prefix + ".weight"])}
    if bias and prefix + ".bias" in sd:
        p["bias"] = np.asarray(sd[prefix + ".bias"])
    return p


def _conv2d(sd, prefix, bias=True):
    p = {"kernel": _conv(sd[prefix + ".weight"])}
    if bias and prefix + ".bias" in sd:
        p["bias"] = np.asarray(sd[prefix + ".bias"])
    return p


def _mha(sd, prefix):
    return {
        "in_proj": {
            "kernel": _t(sd[prefix + ".in_proj_weight"]),
            "bias": np.asarray(sd[prefix + ".in_proj_bias"]),
        },
        "out_proj": _linear(sd, prefix + ".out_proj"),
    }


def convert_swin_backbone(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """``backbone.*`` keys (D2SwinTransformer) → swin param tree."""
    scfg = cfg.swin
    p: Dict = {"patch_embed": {"proj": _conv2d(sd, "backbone.patch_embed.proj")}}
    if "backbone.patch_embed.norm.weight" in sd:
        p["patch_embed"]["norm"] = _ln(sd, "backbone.patch_embed.norm")
    if "backbone.absolute_pos_embed" in sd:
        # D2 Swin stores (1, embed_dim, Wh, Ww); the tree holds (1, H, W, C)
        p["absolute_pos_embed"] = np.asarray(sd["backbone.absolute_pos_embed"]).transpose(0, 2, 3, 1)

    layers: List[Dict] = []
    for i in range(scfg.num_layers):
        blocks = []
        for j in range(scfg.depths[i]):
            pre = f"backbone.layers.{i}.blocks.{j}"
            blocks.append(
                {
                    "norm1": _ln(sd, pre + ".norm1"),
                    "attn": {
                        "relative_position_bias_table": np.asarray(
                            sd[pre + ".attn.relative_position_bias_table"]
                        ),
                        "qkv": _linear(sd, pre + ".attn.qkv"),
                        "proj": _linear(sd, pre + ".attn.proj"),
                    },
                    "norm2": _ln(sd, pre + ".norm2"),
                    "mlp": {
                        "fc1": _linear(sd, pre + ".mlp.fc1"),
                        "fc2": _linear(sd, pre + ".mlp.fc2"),
                    },
                }
            )
        layer = {"blocks": blocks}
        if f"backbone.layers.{i}.downsample.norm.weight" in sd:
            layer["downsample"] = {
                "norm": _ln(sd, f"backbone.layers.{i}.downsample.norm"),
                "reduction": _linear(sd, f"backbone.layers.{i}.downsample.reduction", bias=False),
            }
        layers.append(layer)
    p["layers"] = layers
    for i in range(scfg.num_layers):
        if f"backbone.norm{i}.weight" in sd:
            p[f"norm{i}"] = _ln(sd, f"backbone.norm{i}")
    return p


def convert_pixel_decoder(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """``sem_seg_head.pixel_decoder.*`` (MSDeformAttnPixelDecoder) → pixel decoder tree."""
    pre = "sem_seg_head.pixel_decoder"
    p: Dict = {"input_proj": []}
    i = 0
    while f"{pre}.input_proj.{i}.0.weight" in sd:
        p["input_proj"].append(
            {
                "conv": _conv2d(sd, f"{pre}.input_proj.{i}.0"),
                "gn": _ln(sd, f"{pre}.input_proj.{i}.1"),
            }
        )
        i += 1

    enc_layers = []
    i = 0
    while f"{pre}.transformer.encoder.layers.{i}.norm1.weight" in sd:
        lpre = f"{pre}.transformer.encoder.layers.{i}"
        enc_layers.append(
            {
                "self_attn": {
                    "sampling_offsets": _linear(sd, lpre + ".self_attn.sampling_offsets"),
                    "attention_weights": _linear(sd, lpre + ".self_attn.attention_weights"),
                    "value_proj": _linear(sd, lpre + ".self_attn.value_proj"),
                    "output_proj": _linear(sd, lpre + ".self_attn.output_proj"),
                },
                "norm1": _ln(sd, lpre + ".norm1"),
                "linear1": _linear(sd, lpre + ".linear1"),
                "linear2": _linear(sd, lpre + ".linear2"),
                "norm2": _ln(sd, lpre + ".norm2"),
            }
        )
        i += 1
    p["transformer"] = {
        "level_embed": np.asarray(sd[f"{pre}.transformer.level_embed"]),
        "encoder": {"layers": enc_layers},
    }

    # FPN: adapter_k (lateral 1x1 + GN) / layer_k (3x3 + GN); k starts at 1 for the
    # highest-resolution feature (res2), stored bottom-up
    fpn = []
    k = 1
    while f"{pre}.adapter_{k}.weight" in sd:
        fpn.append(
            {
                "lateral": {
                    "conv": {"kernel": _conv(sd[f"{pre}.adapter_{k}.weight"])},
                    "gn": _ln(sd, f"{pre}.adapter_{k}.norm"),
                },
                "output": {
                    "conv": {"kernel": _conv(sd[f"{pre}.layer_{k}.weight"])},
                    "gn": _ln(sd, f"{pre}.layer_{k}.norm"),
                },
            }
        )
        k += 1
    p["fpn"] = fpn
    p["mask_features"] = _conv2d(sd, f"{pre}.mask_features")
    return p


def convert_predictor(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """``sem_seg_head.predictor.*`` (MultiScaleMaskedTransformerDecoder) → decoder tree."""
    pre = "sem_seg_head.predictor"
    p: Dict = {
        "query_feat": np.asarray(sd[f"{pre}.query_feat.weight"]),
        "query_embed": np.asarray(sd[f"{pre}.query_embed.weight"]),
        "level_embed": np.asarray(sd[f"{pre}.level_embed.weight"]),
        "decoder_norm": _ln(sd, f"{pre}.decoder_norm"),
        "class_embed": _linear(sd, f"{pre}.class_embed"),
        "mask_embed": {"layers": [_linear(sd, f"{pre}.mask_embed.layers.{j}") for j in range(3)]},
        "cross_layers": [],
        "self_layers": [],
        "ffn_layers": [],
    }
    i = 0
    while f"{pre}.transformer_cross_attention_layers.{i}.norm.weight" in sd:
        p["cross_layers"].append(
            {
                "attn": _mha(sd, f"{pre}.transformer_cross_attention_layers.{i}.multihead_attn"),
                "norm": _ln(sd, f"{pre}.transformer_cross_attention_layers.{i}.norm"),
            }
        )
        p["self_layers"].append(
            {
                "attn": _mha(sd, f"{pre}.transformer_self_attention_layers.{i}.self_attn"),
                "norm": _ln(sd, f"{pre}.transformer_self_attention_layers.{i}.norm"),
            }
        )
        p["ffn_layers"].append(
            {
                "linear1": _linear(sd, f"{pre}.transformer_ffn_layers.{i}.linear1"),
                "linear2": _linear(sd, f"{pre}.transformer_ffn_layers.{i}.linear2"),
                "norm": _ln(sd, f"{pre}.transformer_ffn_layers.{i}.norm"),
            }
        )
        i += 1

    # per-level input projections exist only when conv_dim != hidden_dim
    if f"{pre}.input_proj.0.weight" in sd:
        projs = []
        j = 0
        while f"{pre}.input_proj.{j}.weight" in sd:
            projs.append(_conv2d(sd, f"{pre}.input_proj.{j}"))
            j += 1
        p["input_proj"] = projs

    if f"{pre}.ood_pred.conv.weight" in sd:  # DenseHybrid head
        p["ood_pred"] = {
            "bn": {
                "scale": np.asarray(sd[f"{pre}.ood_pred.norm.weight"]),
                "bias": np.asarray(sd[f"{pre}.ood_pred.norm.bias"]),
                "mean": np.asarray(sd[f"{pre}.ood_pred.norm.running_mean"]),
                "var": np.asarray(sd[f"{pre}.ood_pred.norm.running_var"]),
            },
            "conv": _conv2d(sd, f"{pre}.ood_pred.conv"),
        }
    return p


def convert_backbone(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """The backbone's tree; Swin is the one backbone the port runs."""
    if cfg.backbone_name == "swin":
        return convert_swin_backbone(sd, cfg)
    raise NotImplementedError(f"the converter for backbone {cfg.backbone_name!r} {_LATER}")


def convert_d2_state_dict(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """Full D2 state dict → parameter pytree of a Swin / MSDeformAttn / masked-decoder
    model (``MaskFormerHead``), with the historical renames applied first."""
    later = [name for name, hit in (
        (f"pixel decoder {cfg.pixel_decoder.name!r}", cfg.pixel_decoder.name != "MSDeformAttnPixelDecoder"),
        (f"head {cfg.sem_seg_head_name!r}", cfg.sem_seg_head_name != "MaskFormerHead"),
        (f"decoder {cfg.decoder.name!r}", cfg.decoder.name != "MultiScaleMaskedTransformerDecoder"),
    ) if hit]
    if later:
        raise NotImplementedError(f"the converter for {', '.join(later)} {_LATER}")
    sd = apply_historical_renames(sd)
    head = {"pixel_decoder": convert_pixel_decoder(sd, cfg), "predictor": convert_predictor(sd, cfg)}
    return {"backbone": convert_backbone(sd, cfg), "sem_seg_head": head}
