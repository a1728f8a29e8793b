"""Detectron2 checkpoint → parameter-pytree conversion (a copy of ``rba_tpu/convert/d2_mapping.py``:
every backbone, pixel decoder, decoder and head).

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

``rba_tpu`` sends the per-pixel and simple decoders to the masked decoder's converter,
which needs leaves they do not have (ROADMAP.md §C.18); here the class head is read
where the dict has one, and the simple decoder reads the masked decoder's names of its
one cross-attention layer.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from ..config import RbAConfig


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


def _bn(sd, prefix):
    return {
        "scale": np.asarray(sd[prefix + ".weight"]),
        "bias": np.asarray(sd[prefix + ".bias"]),
        "mean": np.asarray(sd[prefix + ".running_mean"]),
        "var": np.asarray(sd[prefix + ".running_var"]),
    }


def convert_vit_backbone(sd: Dict[str, np.ndarray], prefix: str = "backbone") -> Dict:
    """ViTDet ``{prefix}.*`` keys (reference backbone/vit.py D2ViT) →
    vit param tree (rba_tpu/models/vit.py vit_init layout)."""
    p: Dict = {"patch_embed": {"proj": _conv2d(sd, f"{prefix}.patch_embed.proj")}}
    if f"{prefix}.pos_embed" in sd:
        p["pos_embed"] = np.asarray(sd[f"{prefix}.pos_embed"])  # (1, tokens, C)
    blocks: List[Dict] = []
    i = 0
    while f"{prefix}.blocks.{i}.norm1.weight" in sd:
        pre = f"{prefix}.blocks.{i}"
        blk: Dict = {
            "norm1": _ln(sd, pre + ".norm1"),
            "attn": {
                "qkv": _linear(sd, pre + ".attn.qkv"),
                "proj": _linear(sd, pre + ".attn.proj"),
            },
            "norm2": _ln(sd, pre + ".norm2"),
            "mlp": {
                "fc1": _linear(sd, pre + ".mlp.fc1"),
                "fc2": _linear(sd, pre + ".mlp.fc2"),
            },
        }
        if pre + ".attn.rel_pos_h" in sd:
            blk["attn"]["rel_pos_h"] = np.asarray(sd[pre + ".attn.rel_pos_h"])
            blk["attn"]["rel_pos_w"] = np.asarray(sd[pre + ".attn.rel_pos_w"])
        if pre + ".residual.conv1.weight" in sd:
            blk["residual"] = {
                "conv1": _conv2d(sd, pre + ".residual.conv1"),
                "norm1": _ln(sd, pre + ".residual.norm1"),
                "conv2": _conv2d(sd, pre + ".residual.conv2"),
                "norm2": _ln(sd, pre + ".residual.norm2"),
                "conv3": _conv2d(sd, pre + ".residual.conv3"),
                "norm3": _ln(sd, pre + ".residual.norm3"),
            }
        blocks.append(blk)
        i += 1
    p["blocks"] = blocks
    return p


def _convt(sd, prefix):
    """ConvTranspose2d IOHW → our HWIO conv-transpose kernel."""
    p = {"kernel": np.ascontiguousarray(np.asarray(sd[prefix + ".weight"]).transpose(2, 3, 0, 1))}
    if prefix + ".bias" in sd:
        p["bias"] = np.asarray(sd[prefix + ".bias"])
    return p


def convert_sfp(sd: Dict[str, np.ndarray],
                scale_factors=(4.0, 2.0, 1.0, 0.5)) -> Dict:
    """SimpleFeaturePyramid ``backbone.simfp_{2..5}.*`` keys (reference
    vit.py:478-525: Sequential indices — scale 4: convT@0, LN@1, GELU@2,
    convT@3, lateral@4, output@5; scale 2: convT@0, lateral@1, output@2;
    scale 1: lateral@0, output@1; scale 0.5: maxpool@0, lateral@1, output@2)."""
    stages = []
    for scale in scale_factors:
        stage_id = {4.0: 2, 2.0: 3, 1.0: 4, 0.5: 5}[scale]
        pre = f"backbone.simfp_{stage_id}"
        stage: Dict = {"scale": scale}
        if scale == 4.0:
            stage["up1"] = _convt(sd, f"{pre}.0")
            stage["up1_norm"] = _ln(sd, f"{pre}.1")
            stage["up2"] = _convt(sd, f"{pre}.3")
            lat, out = 4, 5
        elif scale == 2.0:
            stage["up1"] = _convt(sd, f"{pre}.0")
            lat, out = 1, 2
        elif scale == 1.0:
            lat, out = 0, 1
        else:  # 0.5 — maxpool at index 0
            lat, out = 1, 2
        stage["lateral"] = {
            "conv": _conv2d(sd, f"{pre}.{lat}"),
            "norm": _ln(sd, f"{pre}.{lat}.norm"),
        }
        stage["output"] = {
            "conv": _conv2d(sd, f"{pre}.{out}"),
            "norm": _ln(sd, f"{pre}.{out}.norm"),
        }
        stages.append(stage)
    return {"stages": stages}


def convert_mvit_backbone(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """MViTv2 ``backbone.*`` keys (reference backbone/mvit.py D2MViT) →
    mvit param tree (rba_tpu/models/mvit.py mvit_init layout)."""
    p: Dict = {"patch_embed": {"proj": _conv2d(sd, "backbone.patch_embed.proj")}}
    if "backbone.pos_embed" in sd:
        p["pos_embed"] = np.asarray(sd["backbone.pos_embed"])
    blocks: List[Dict] = []
    i = 0
    while f"backbone.blocks.{i}.norm1.weight" in sd:
        pre = f"backbone.blocks.{i}"
        blk: Dict = {
            "norm1": _ln(sd, pre + ".norm1"),
            "attn": {
                "qkv": _linear(sd, pre + ".attn.qkv"),
                "proj": _linear(sd, pre + ".attn.proj"),
                "pool_q": {"kernel": _conv(sd[pre + ".attn.pool_q.weight"])},
                "norm_q": _ln(sd, pre + ".attn.norm_q"),
                "pool_k": {"kernel": _conv(sd[pre + ".attn.pool_k.weight"])},
                "norm_k": _ln(sd, pre + ".attn.norm_k"),
                "pool_v": {"kernel": _conv(sd[pre + ".attn.pool_v.weight"])},
                "norm_v": _ln(sd, pre + ".attn.norm_v"),
            },
            "norm2": _ln(sd, pre + ".norm2"),
            "mlp": {
                "fc1": _linear(sd, pre + ".mlp.fc1"),
                "fc2": _linear(sd, pre + ".mlp.fc2"),
            },
        }
        if pre + ".attn.rel_pos_h" in sd:
            blk["attn"]["rel_pos_h"] = np.asarray(sd[pre + ".attn.rel_pos_h"])
            blk["attn"]["rel_pos_w"] = np.asarray(sd[pre + ".attn.rel_pos_w"])
        if pre + ".proj.weight" in sd:  # dim-change projection on the block
            blk["proj"] = _linear(sd, pre + ".proj")
        blocks.append(blk)
        i += 1
    p["blocks"] = blocks
    for k in (2, 3, 4, 5):
        if f"backbone.scale{k}_norm.weight" in sd:
            p[f"scale{k}_norm"] = _ln(sd, f"backbone.scale{k}_norm")
    return p


def convert_mit_backbone(sd: Dict[str, np.ndarray]) -> Dict:
    """MixVisionTransformer ``backbone.*`` keys (reference
    backbone/mix_transformer.py mit_b0..b5) → mit param tree
    (rba_tpu/models/mix_transformer.py mit_init layout: stages[s])."""
    stages: List[Dict] = []
    for s in range(1, 5):
        stage: Dict = {
            "patch_embed": {
                "proj": _conv2d(sd, f"backbone.patch_embed{s}.proj"),
                "norm": _ln(sd, f"backbone.patch_embed{s}.norm"),
            },
            "blocks": [],
            "norm": _ln(sd, f"backbone.norm{s}"),
        }
        b = 0
        while f"backbone.block{s}.{b}.norm1.weight" in sd:
            pre = f"backbone.block{s}.{b}"
            blk: Dict = {
                "norm1": _ln(sd, pre + ".norm1"),
                "attn": {
                    "q": _linear(sd, pre + ".attn.q"),
                    "kv": _linear(sd, pre + ".attn.kv"),
                    "proj": _linear(sd, pre + ".attn.proj"),
                },
                "norm2": _ln(sd, pre + ".norm2"),
                "mlp": {
                    "fc1": _linear(sd, pre + ".mlp.fc1"),
                    "dwconv": _conv2d(sd, pre + ".mlp.dwconv.dwconv"),
                    "fc2": _linear(sd, pre + ".mlp.fc2"),
                },
            }
            if pre + ".attn.sr.weight" in sd:
                blk["attn"]["sr"] = _conv2d(sd, pre + ".attn.sr")
                blk["attn"]["sr_norm"] = _ln(sd, pre + ".attn.norm")
            stage["blocks"].append(blk)
            b += 1
        stages.append(stage)
    return {"stages": stages}


def convert_wideresnet_backbone(sd: Dict[str, np.ndarray]) -> Dict:
    """WiderResNetA2 ``backbone.*`` keys (reference backbone/wideresnet38.py:
    mod1.conv1, mod{2..7}.block{k}.bn1/convs.conv*/convs.bn*/proj_conv,
    bn_out) → wideresnet param tree."""
    p: Dict = {"mod1": {"kernel": _conv(sd["backbone.mod1.conv1.weight"])}}
    for mod in range(2, 8):
        blocks: List[Dict] = []
        b = 1
        while f"backbone.mod{mod}.block{b}.bn1.weight" in sd:
            pre = f"backbone.mod{mod}.block{b}"
            blk: Dict = {
                "bn1": _bn(sd, pre + ".bn1"),
                "conv1": {"kernel": _conv(sd[pre + ".convs.conv1.weight"])},
                "bn2": _bn(sd, pre + ".convs.bn2"),
                "conv2": {"kernel": _conv(sd[pre + ".convs.conv2.weight"])},
            }
            if pre + ".convs.bn3.weight" in sd:  # bottleneck block
                blk["bn3"] = _bn(sd, pre + ".convs.bn3")
                blk["conv3"] = {"kernel": _conv(sd[pre + ".convs.conv3.weight"])}
            if pre + ".proj_conv.weight" in sd:
                blk["proj_conv"] = {"kernel": _conv(sd[pre + ".proj_conv.weight"])}
            blocks.append(blk)
            b += 1
        p[f"mod{mod}"] = blocks
    p["bn_out"] = _bn(sd, "backbone.bn_out")
    return p


def convert_resnet_backbone(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """D2 ResNet ``backbone.*`` keys (stem.conv1(.norm), res{2..5}.{b}.conv{1..3}
    (.norm), res*.0.shortcut(.norm)) → resnet param tree.  The D2 layout is
    what DetectionCheckpointer loads; a torchvision .pth is first mapped by
    ``torchvision_resnet_to_d2`` (``tools/convert_checkpoint.py torchvision``)."""
    p: Dict = {
        "stem": {
            "conv1": {"kernel": _conv(sd["backbone.stem.conv1.weight"])},
            "norm1": _bn(sd, "backbone.stem.conv1.norm"),
        }
    }
    for stage, n_blocks in enumerate(cfg.resnet.stage_blocks):
        name = f"res{stage + 2}"
        blocks: List[Dict] = []
        for b in range(n_blocks):
            pre = f"backbone.{name}.{b}"
            blk: Dict = {
                "conv1": {"kernel": _conv(sd[pre + ".conv1.weight"])},
                "norm1": _bn(sd, pre + ".conv1.norm"),
                "conv2": {"kernel": _conv(sd[pre + ".conv2.weight"])},
                "norm2": _bn(sd, pre + ".conv2.norm"),
                "conv3": {"kernel": _conv(sd[pre + ".conv3.weight"])},
                "norm3": _bn(sd, pre + ".conv3.norm"),
            }
            if pre + ".shortcut.weight" in sd:
                blk["shortcut"] = {"kernel": _conv(sd[pre + ".shortcut.weight"])}
                blk["shortcut_norm"] = _bn(sd, pre + ".shortcut.norm")
            blocks.append(blk)
        p[name] = blocks
    return p


def torchvision_resnet_to_d2(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torchvision ResNet state-dict names → Detectron2 names, the mapping of the
    reference's ``tools/convert-torchvision-to-d2.py``: ``conv1``/``bn1`` → the stem,
    ``layer{L}`` → ``res{L+1}``, ``bn{k}`` → ``conv{k}.norm``, ``downsample.0``/``.1`` →
    ``shortcut``/``shortcut.norm``; the classifier and ``num_batches_tracked`` dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            continue
        nk = k
        if nk.startswith("conv1."):
            nk = nk.replace("conv1.", "stem.conv1.")
        if nk.startswith("bn1."):
            nk = nk.replace("bn1.", "stem.conv1.norm.")
        for layer in range(1, 5):
            nk = nk.replace(f"layer{layer}.", f"res{layer + 1}.")
        nk = re.sub(r"\.bn(\d)\.", r".conv\1.norm.", nk)
        nk = nk.replace(".downsample.0.", ".shortcut.")
        nk = nk.replace(".downsample.1.", ".shortcut.norm.")
        if "num_batches_tracked" in nk:
            continue
        out["backbone." + nk] = np.asarray(v)
    return out


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


def convert_fpn_pixel_decoder(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """``sem_seg_head.pixel_decoder.*`` of ``BasePixelDecoder`` / ``TransformerEncoderPixelDecoder``
    → their tree: ``adapter_k`` laterals and ``layer_k`` output convs numbered from 1 at
    the finest feature, stored top-down; the top feature has no adapter; the encoder
    variant adds ``input_proj``, the DETR encoder and, under pre-norm, its final norm."""
    pre = "sem_seg_head.pixel_decoder"
    n = len(cfg.pixel_decoder.in_features)
    stages = []
    for k in range(n, 0, -1):
        stage: Dict = {}
        if k < n:
            stage["lateral"] = {"conv": {"kernel": _conv(sd[f"{pre}.adapter_{k}.weight"])},
                                "gn": _ln(sd, f"{pre}.adapter_{k}.norm")}
        stage["output"] = {"conv": {"kernel": _conv(sd[f"{pre}.layer_{k}.weight"])},
                           "gn": _ln(sd, f"{pre}.layer_{k}.norm")}
        stages.append(stage)
    p: Dict = {"stages": stages, "mask_features": _conv2d(sd, f"{pre}.mask_features")}
    if f"{pre}.input_proj.weight" in sd:
        p["input_proj"] = _conv2d(sd, f"{pre}.input_proj")
        p["encoder"] = _detr_layers(sd, f"{pre}.transformer.encoder", _detr_encoder_layer)
        if f"{pre}.transformer.encoder.norm.weight" in sd:
            p["encoder_norm"] = _ln(sd, f"{pre}.transformer.encoder.norm")
    return p


def _detr_encoder_layer(sd, lp):
    return {"attn": _mha(sd, lp + ".self_attn"), "norm1": _ln(sd, lp + ".norm1"),
            "linear1": _linear(sd, lp + ".linear1"), "linear2": _linear(sd, lp + ".linear2"),
            "norm2": _ln(sd, lp + ".norm2")}


def _detr_decoder_layer(sd, lp):
    return {"self_attn": _mha(sd, lp + ".self_attn"), "norm1": _ln(sd, lp + ".norm1"),
            "cross_attn": _mha(sd, lp + ".multihead_attn"), "norm2": _ln(sd, lp + ".norm2"),
            "linear1": _linear(sd, lp + ".linear1"), "linear2": _linear(sd, lp + ".linear2"),
            "norm3": _ln(sd, lp + ".norm3")}


def _detr_layers(sd, prefix, convert) -> List[Dict]:
    out, i = [], 0
    while f"{prefix}.layers.{i}.norm1.weight" in sd:
        out.append(convert(sd, f"{prefix}.layers.{i}"))
        i += 1
    return out


def convert_standard_decoder(sd: Dict[str, np.ndarray], cfg: RbAConfig, mask_classification: bool = True) -> Dict:
    """``sem_seg_head.predictor.*`` of MaskFormer v1's ``StandardTransformerDecoder`` (DETR's
    ``transformer.encoder/decoder.layers.{i}``, cross-attention ``multihead_attn``) → its
    tree.  An identity ``input_proj`` (the input already at the hidden width) has no
    leaves: it becomes a 1x1 eye conv."""
    pre = "sem_seg_head.predictor"
    hd = cfg.decoder.hidden_dim
    p: Dict = {
        "query_embed": np.asarray(sd[f"{pre}.query_embed.weight"]),
        "decoder_norm": _ln(sd, f"{pre}.transformer.decoder.norm"),
        "mask_embed": {"layers": [_linear(sd, f"{pre}.mask_embed.layers.{j}") for j in range(3)]},
    }
    if f"{pre}.input_proj.weight" in sd:
        p["input_proj"] = _conv2d(sd, f"{pre}.input_proj")
    else:
        p["input_proj"] = {"kernel": np.eye(hd, dtype=np.float32).reshape(1, 1, hd, hd),
                           "bias": np.zeros((hd,), np.float32)}
    if mask_classification and f"{pre}.class_embed.weight" in sd:
        p["class_embed"] = _linear(sd, f"{pre}.class_embed")
    p["enc_layers"] = _detr_layers(sd, f"{pre}.transformer.encoder", _detr_encoder_layer)
    p["dec_layers"] = _detr_layers(sd, f"{pre}.transformer.decoder", _detr_decoder_layer)
    if f"{pre}.transformer.encoder.norm.weight" in sd:
        p["encoder_norm"] = _ln(sd, f"{pre}.transformer.encoder.norm")
    return p


def convert_simple_decoder(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """``sem_seg_head.predictor.*`` of ``SimpleTransformerDecoder`` under the masked
    decoder's names (``rba_tpu``'s dispatch sends it to that converter): the queries, the
    first cross-attention layer, the norm and both heads."""
    pre = "sem_seg_head.predictor"
    return {
        "query_feat": np.asarray(sd[f"{pre}.query_feat.weight"]),
        "query_embed": np.asarray(sd[f"{pre}.query_embed.weight"]),
        "cross_attention": {
            "attn": _mha(sd, f"{pre}.transformer_cross_attention_layers.0.multihead_attn"),
            "norm": _ln(sd, f"{pre}.transformer_cross_attention_layers.0.norm"),
        },
        "decoder_norm": _ln(sd, f"{pre}.decoder_norm"),
        "class_embed": _linear(sd, f"{pre}.class_embed"),
        "mask_embed": {"layers": [_linear(sd, f"{pre}.mask_embed.layers.{j}") for j in range(3)]},
    }


def convert_predictor(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """``sem_seg_head.predictor.*`` (MultiScaleMaskedTransformerDecoder, and
    MultiScalePerPixelDecoder, which has no ``class_embed``) → decoder tree."""
    pre = "sem_seg_head.predictor"
    p: Dict = {
        "query_feat": np.asarray(sd[f"{pre}.query_feat.weight"]),
        "query_embed": np.asarray(sd[f"{pre}.query_embed.weight"]),
        "level_embed": np.asarray(sd[f"{pre}.level_embed.weight"]),
        "decoder_norm": _ln(sd, f"{pre}.decoder_norm"),
        "mask_embed": {"layers": [_linear(sd, f"{pre}.mask_embed.layers.{j}") for j in range(3)]},
        "cross_layers": [],
        "self_layers": [],
        "ffn_layers": [],
    }
    if f"{pre}.class_embed.weight" in sd or cfg.decoder.name != "MultiScalePerPixelDecoder":
        p["class_embed"] = _linear(sd, f"{pre}.class_embed")
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
    """The backbone's tree, by ``cfg.backbone_name``."""
    name = cfg.backbone_name
    if name == "swin":
        return convert_swin_backbone(sd, cfg)
    if name == "vit":
        return convert_vit_backbone(sd)
    if name == "vit_sfp":  # the pyramid wraps the net: the ViT's keys are under backbone.net
        return {"vit": convert_vit_backbone(sd, prefix="backbone.net"), "sfp": convert_sfp(sd)}
    if name == "mvit":
        return convert_mvit_backbone(sd, cfg)
    if name == "mix_transformer" or name.startswith("mit_"):
        return convert_mit_backbone(sd)
    if name == "resnet":
        return convert_resnet_backbone(sd, cfg)
    if name == "wideresnet38":
        return convert_wideresnet_backbone(sd)
    raise NotImplementedError(f"the converter for backbone {name!r}")


def convert_d2_state_dict(sd: Dict[str, np.ndarray], cfg: RbAConfig) -> Dict:
    """Full D2 state dict → parameter pytree, by ``SEM_SEG_HEAD.NAME``,
    ``PIXEL_DECODER_NAME`` and ``TRANSFORMER_DECODER_NAME`` as the reference's registries
    dispatch, with the historical renames applied first."""
    sd = apply_historical_renames(sd)
    if cfg.pixel_decoder.name == "MSDeformAttnPixelDecoder":
        pd = convert_pixel_decoder(sd, cfg)
    else:
        pd = convert_fpn_pixel_decoder(sd, cfg)
    head_name = cfg.sem_seg_head_name
    if head_name == "PerPixelBaselineHead":
        pred = _conv2d(sd, "sem_seg_head.predictor")
    elif head_name == "PerPixelBaselinePlusHead":
        pred = convert_standard_decoder(sd, cfg, mask_classification=False)
    elif cfg.decoder.name == "StandardTransformerDecoder":
        pred = convert_standard_decoder(sd, cfg)
    elif cfg.decoder.name in ("SimpleDecoder", "SimpleTransformerDecoder"):
        pred = convert_simple_decoder(sd, cfg)
    else:
        pred = convert_predictor(sd, cfg)
    return {"backbone": convert_backbone(sd, cfg), "sem_seg_head": {"pixel_decoder": pd, "predictor": pred}}
