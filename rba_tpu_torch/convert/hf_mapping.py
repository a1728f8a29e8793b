"""HuggingFace ``transformers`` checkpoints → Detectron2 names (counterpart of
``rba_tpu/convert/hf_mapping.py``).

The four mappings rename an HF state dict (torch tensors or numpy arrays) to the
Detectron2 names of the reference's checkpoints, so that ``convert/d2_mapping.py`` does
the layout work:

- ``hf_mask2former_to_d2``: ``Mask2FormerForUniversalSegmentation`` (Swin backbone,
  MSDeformAttn pixel decoder, masked-attention decoder), e.g. the
  ``facebook/mask2former-swin-*-cityscapes-semantic`` checkpoints that RbA fine-tunes;
- ``hf_maskformer_v1_to_d2``: ``MaskFormerForInstanceSegmentation`` (pad-style Swin,
  the FPN ``BasePixelDecoder``, the DETR ``StandardTransformerDecoder``);
- ``hf_segformer_to_d2``: a SegFormer encoder (MiT) → ``backbone.*``;
- ``hf_vitdet_to_d2``: ``VitDetModel`` → ``backbone.*``.

HF's Swin keeps separate ``query``/``key``/``value`` linears where Detectron2 fuses them
as ``qkv`` (rows [q; k; v], as ``nn.MultiheadAttention``'s ``in_proj`` orders them);
buffers (``relative_position_index``) and ``criterion.*`` leaves are dropped.
``rba_config_from_hf`` reads an HF Mask2Former config's attributes into the port's
config, and ``convert_hf_checkpoint`` converts a model object or a state dict with a
config.  Nothing here imports ``transformers``.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np


_BB = "model.pixel_level_module.encoder."
_PD = "model.pixel_level_module.decoder."
_TM = "model.transformer_module."


def _fuse_qkv(sd: Dict[str, np.ndarray], q: str, k: str, v: str, leaf: str):
    return np.concatenate(
        [np.asarray(sd[q + leaf]), np.asarray(sd[k + leaf]), np.asarray(sd[v + leaf])],
        axis=0,
    )


def hf_mask2former_to_d2(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF Mask2Former state dict (torch tensors or ndarrays) → D2-named
    ndarray dict consumable by convert/d2_mapping.convert_d2_state_dict."""
    sd = {
        k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in sd.items()
    }
    out: Dict[str, np.ndarray] = {}
    fused = set()  # HF q/k/v prefixes already fused

    for k, v in sd.items():
        if k.startswith("criterion.") or k.endswith("relative_position_index"):
            continue

        # ---------------- Swin backbone ----------------
        if k.startswith(_BB):
            r = k[len(_BB):]
            if r.startswith("embeddings.patch_embeddings.projection."):
                out["backbone.patch_embed.proj." + r.rsplit(".", 1)[1]] = v
                continue
            if r.startswith("embeddings.norm."):
                out["backbone.patch_embed.norm." + r.rsplit(".", 1)[1]] = v
                continue
            m = re.match(r"hidden_states_norms\.stage(\d+)\.(weight|bias)$", r)
            if m:
                out[f"backbone.norm{int(m.group(1)) - 1}.{m.group(2)}"] = v
                continue
            m = re.match(r"encoder\.layers\.(\d+)\.downsample\.(norm|reduction)\.(.+)$", r)
            if m:
                out[f"backbone.layers.{m.group(1)}.downsample.{m.group(2)}.{m.group(3)}"] = v
                continue
            m = re.match(r"encoder\.layers\.(\d+)\.blocks\.(\d+)\.(.+)$", r)
            if m:
                pre = f"backbone.layers.{m.group(1)}.blocks.{m.group(2)}"
                rest = m.group(3)
                if rest.startswith("attention.self."):
                    leaf = rest[len("attention.self."):]
                    if leaf == "relative_position_bias_table":
                        out[pre + ".attn.relative_position_bias_table"] = v
                    elif leaf.split(".")[0] in ("query", "key", "value"):
                        hp = _BB + f"encoder.layers.{m.group(1)}.blocks.{m.group(2)}.attention.self."
                        suffix = leaf.split(".")[1]  # weight | bias
                        if (hp, suffix) not in fused:
                            fused.add((hp, suffix))
                            out[pre + ".attn.qkv." + suffix] = _fuse_qkv(
                                sd, hp + "query.", hp + "key.", hp + "value.", suffix
                            )
                elif rest.startswith("attention.output.dense."):
                    out[pre + ".attn.proj." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("layernorm_before."):
                    out[pre + ".norm1." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("layernorm_after."):
                    out[pre + ".norm2." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("intermediate.dense."):
                    out[pre + ".mlp.fc1." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("output.dense."):
                    out[pre + ".mlp.fc2." + rest.rsplit(".", 1)[1]] = v
                continue
            continue

        # ---------------- MSDeformAttn pixel decoder ----------------
        if k.startswith(_PD):
            r = k[len(_PD):]
            pre = "sem_seg_head.pixel_decoder."
            if r == "level_embed":
                out[pre + "transformer.level_embed"] = v
                continue
            if r.startswith("mask_projection."):
                out[pre + "mask_features." + r.rsplit(".", 1)[1]] = v
                continue
            m = re.match(r"input_projections\.(\d+)\.([01])\.(weight|bias)$", r)
            if m:
                out[pre + f"input_proj.{m.group(1)}.{m.group(2)}.{m.group(3)}"] = v
                continue
            m = re.match(r"(adapter|layer)_(\d+)\.([01])\.(weight|bias)$", r)
            if m:  # Sequential [conv, GN] → D2 Conv2d-with-norm names
                tail = m.group(4) if m.group(3) == "0" else "norm." + m.group(4)
                out[pre + f"{m.group(1)}_{m.group(2)}.{tail}"] = v
                continue
            m = re.match(r"encoder\.layers\.(\d+)\.(.+)$", r)
            if m:
                lp = pre + f"transformer.encoder.layers.{m.group(1)}."
                rest = m.group(2)
                rest = rest.replace("self_attn_layer_norm.", "norm1.")
                rest = rest.replace("final_layer_norm.", "norm2.")
                rest = rest.replace("fc1.", "linear1.").replace("fc2.", "linear2.")
                out[lp + rest] = v
                continue
            continue

        # ---------------- masked-attention transformer decoder ----------------
        if k.startswith(_TM):
            r = k[len(_TM):]
            pre = "sem_seg_head.predictor."
            if r == "queries_embedder.weight":
                out[pre + "query_embed.weight"] = v
                continue
            if r == "queries_features.weight":
                out[pre + "query_feat.weight"] = v
                continue
            if r == "level_embed.weight":
                out[pre + "level_embed.weight"] = v
                continue
            m = re.match(r"input_projections\.(\d+)\.(weight|bias)$", r)
            if m:
                out[pre + f"input_proj.{m.group(1)}.{m.group(2)}"] = v
                continue
            if r.startswith("decoder.layernorm."):
                out[pre + "decoder_norm." + r.rsplit(".", 1)[1]] = v
                continue
            m = re.match(r"decoder\.mask_predictor\.mask_embedder\.(\d+)\.0\.(weight|bias)$", r)
            if m:
                out[pre + f"mask_embed.layers.{m.group(1)}.{m.group(2)}"] = v
                continue
            m = re.match(r"decoder\.layers\.(\d+)\.(.+)$", r)
            if m:
                i, rest = m.group(1), m.group(2)
                if rest.startswith("cross_attn."):
                    out[pre + f"transformer_cross_attention_layers.{i}.multihead_attn."
                        + rest[len("cross_attn."):]] = v
                elif rest.startswith("cross_attn_layer_norm."):
                    out[pre + f"transformer_cross_attention_layers.{i}.norm."
                        + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("self_attn."):
                    leaf = rest[len("self_attn."):]
                    sp = pre + f"transformer_self_attention_layers.{i}.self_attn."
                    if leaf.split(".")[0] in ("q_proj", "k_proj", "v_proj"):
                        hp = _TM + f"decoder.layers.{i}.self_attn."
                        suffix = leaf.split(".")[1]
                        if (hp, suffix) not in fused:
                            fused.add((hp, suffix))
                            out[sp + "in_proj_" + suffix] = _fuse_qkv(
                                sd, hp + "q_proj.", hp + "k_proj.", hp + "v_proj.", suffix
                            )
                    else:  # out_proj.{weight,bias}
                        out[sp + leaf] = v
                elif rest.startswith("self_attn_layer_norm."):
                    out[pre + f"transformer_self_attention_layers.{i}.norm."
                        + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("fc1."):
                    out[pre + f"transformer_ffn_layers.{i}.linear1." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("fc2."):
                    out[pre + f"transformer_ffn_layers.{i}.linear2." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("final_layer_norm."):
                    out[pre + f"transformer_ffn_layers.{i}.norm." + rest.rsplit(".", 1)[1]] = v
                continue
            continue

        # ---------------- meta-arch heads ----------------
        if k.startswith("class_predictor."):
            out["sem_seg_head.predictor.class_embed." + k.rsplit(".", 1)[1]] = v
            continue

    return out


def hf_maskformer_v1_to_d2(sd: Dict[str, np.ndarray], n_features: int = 4) -> Dict[str, np.ndarray]:
    """HF ``MaskFormerForInstanceSegmentation`` (v1 MaskFormer: pad-style
    Swin → FPN BasePixelDecoder → DETR transformer decoder) → D2 names of
    the reference's v1 path (maskformer_transformer_decoder.py + DETR
    transformer.py + pixel_decoder/fpn.py BasePixelDecoder).

    HF's ``maskformer_swin`` replicates the ORIGINAL D2 pad-style Swin
    (zero-pads sub-window stages instead of shrinking the window like
    modeling_swin), so this mapping cross-validates exactly the padding
    semantics the released checkpoints rely on.  FPN numbering: the D2
    BasePixelDecoder names output convs ``layer_{k}``, laterals
    ``adapter_{k}``, k=1 at the highest resolution; HF's ``fpn.stem`` is
    the top (k = n_features) and ``fpn.layers[i]`` walks down from
    k = n_features - 1."""
    sd = {
        k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in sd.items()
    }
    out: Dict[str, np.ndarray] = {}
    fused = set()
    bb = "model.pixel_level_module.encoder.model."
    pd = "model.pixel_level_module.decoder."
    tm = "model.transformer_module."
    for k, v in sd.items():
        if k.startswith("criterion.") or k.endswith("relative_position_index"):
            continue
        if k.startswith("model.pixel_level_module.encoder.hidden_states_norms."):
            i, leaf = k.rsplit(".", 2)[-2:]
            out[f"backbone.norm{i}.{leaf}"] = v
            continue
        if k.startswith(bb):
            r = k[len(bb):]
            if r.startswith("layernorm."):
                continue  # SwinModel pooling-head norm, unused by the backbone
            if r.startswith("embeddings.patch_embeddings.projection."):
                out["backbone.patch_embed.proj." + r.rsplit(".", 1)[1]] = v
                continue
            if r.startswith("embeddings.norm."):
                out["backbone.patch_embed.norm." + r.rsplit(".", 1)[1]] = v
                continue
            m = re.match(r"encoder\.layers\.(\d+)\.downsample\.(norm|reduction)\.(.+)$", r)
            if m:
                out[f"backbone.layers.{m.group(1)}.downsample.{m.group(2)}.{m.group(3)}"] = v
                continue
            m = re.match(r"encoder\.layers\.(\d+)\.blocks\.(\d+)\.(.+)$", r)
            if m:
                pre = f"backbone.layers.{m.group(1)}.blocks.{m.group(2)}"
                rest = m.group(3)
                if rest.startswith("attention.self."):
                    leaf = rest[len("attention.self."):]
                    if leaf == "relative_position_bias_table":
                        out[pre + ".attn.relative_position_bias_table"] = v
                    elif leaf.split(".")[0] in ("query", "key", "value"):
                        hp = bb + f"encoder.layers.{m.group(1)}.blocks.{m.group(2)}.attention.self."
                        suffix = leaf.split(".")[1]
                        if (hp, suffix) not in fused:
                            fused.add((hp, suffix))
                            out[pre + ".attn.qkv." + suffix] = _fuse_qkv(
                                sd, hp + "query.", hp + "key.", hp + "value.", suffix
                            )
                elif rest.startswith("attention.output.dense."):
                    out[pre + ".attn.proj." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("layernorm_before."):
                    out[pre + ".norm1." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("layernorm_after."):
                    out[pre + ".norm2." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("intermediate.dense."):
                    out[pre + ".mlp.fc1." + rest.rsplit(".", 1)[1]] = v
                elif rest.startswith("output.dense."):
                    out[pre + ".mlp.fc2." + rest.rsplit(".", 1)[1]] = v
            continue
        if k.startswith(pd):
            r = k[len(pd):]
            base = "sem_seg_head.pixel_decoder."
            if r.startswith("mask_projection."):
                out[base + "mask_features." + r.rsplit(".", 1)[1]] = v
                continue
            m = re.match(r"fpn\.stem\.([01])\.(weight|bias)$", r)
            if m:
                tail = m.group(2) if m.group(1) == "0" else "norm." + m.group(2)
                out[base + f"layer_{n_features}.{tail}"] = v
                continue
            m = re.match(r"fpn\.layers\.(\d+)\.(proj|block)\.([01])\.(weight|bias)$", r)
            if m:
                kk = n_features - 1 - int(m.group(1))
                name = "adapter" if m.group(2) == "proj" else "layer"
                tail = m.group(4) if m.group(3) == "0" else "norm." + m.group(4)
                out[base + f"{name}_{kk}.{tail}"] = v
                continue
            continue
        if k.startswith(tm):
            r = k[len(tm):]
            base = "sem_seg_head.predictor."
            if r == "queries_embedder.weight":
                out[base + "query_embed.weight"] = v
                continue
            if r.startswith("input_projection."):
                out[base + "input_proj." + r.rsplit(".", 1)[1]] = v
                continue
            if r.startswith("decoder.layernorm."):
                out[base + "transformer.decoder.norm." + r.rsplit(".", 1)[1]] = v
                continue
            m = re.match(r"decoder\.layers\.(\d+)\.(.+)$", r)
            if m:
                lp = base + f"transformer.decoder.layers.{m.group(1)}."
                rest = m.group(2)
                for attn, d2 in (("self_attn", "self_attn"), ("encoder_attn", "multihead_attn")):
                    if rest.startswith(attn + "."):
                        leaf = rest[len(attn) + 1:]
                        if leaf.split(".")[0] in ("q_proj", "k_proj", "v_proj"):
                            hp = tm + f"decoder.layers.{m.group(1)}.{attn}."
                            suffix = leaf.split(".")[1]
                            if (hp, suffix) not in fused:
                                fused.add((hp, suffix))
                                out[lp + d2 + ".in_proj_" + suffix] = _fuse_qkv(
                                    sd, hp + "q_proj.", hp + "k_proj.", hp + "v_proj.", suffix
                                )
                        else:
                            out[lp + d2 + "." + leaf] = v
                        break
                else:
                    rest = rest.replace("self_attn_layer_norm.", "norm1.")
                    rest = rest.replace("encoder_attn_layer_norm.", "norm2.")
                    rest = rest.replace("final_layer_norm.", "norm3.")
                    rest = rest.replace("fc1.", "linear1.").replace("fc2.", "linear2.")
                    out[lp + rest] = v
            continue
        if k.startswith("class_predictor."):
            out["sem_seg_head.predictor.class_embed." + k.rsplit(".", 1)[1]] = v
            continue
        m = re.match(r"mask_embedder\.(\d+)\.0\.(weight|bias)$", k)
        if m:
            out[f"sem_seg_head.predictor.mask_embed.layers.{m.group(1)}.{m.group(2)}"] = v
            continue
    return out


def hf_segformer_to_d2(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF Segformer encoder state dict → the reference's MixTransformer
    ``backbone.*`` names (reference backbone/mix_transformer.py, itself the
    upstream SegFormer MiT; HF's port uses separate key/value linears where
    the original fuses them as ``kv`` with rows [k; v]).  Accepts either a
    ``SegformerModel`` state dict (keys start ``encoder.``) or a bare
    encoder's.  Output feeds convert/d2_mapping.convert_mit_backbone — and
    makes the ``nvidia/mit-b{0..5}`` hub checkpoints (the pretrained weights
    the reference's MiT configs start from) loadable."""
    sd = {
        k.removeprefix("segformer.").removeprefix("encoder."): (
            v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        )
        for k, v in sd.items()
        if ".encoder." in k or k.startswith("encoder.")
    }
    out: Dict[str, np.ndarray] = {}
    fused = set()
    for k, v in sd.items():
        m = re.match(r"patch_embeddings\.(\d+)\.(proj|layer_norm)\.(weight|bias)$", k)
        if m:
            leaf = "proj" if m.group(2) == "proj" else "norm"
            out[f"backbone.patch_embed{int(m.group(1)) + 1}.{leaf}.{m.group(3)}"] = v
            continue
        m = re.match(r"layer_norm\.(\d+)\.(weight|bias)$", k)
        if m:
            out[f"backbone.norm{int(m.group(1)) + 1}.{m.group(2)}"] = v
            continue
        m = re.match(r"block\.(\d+)\.(\d+)\.(.+)$", k)
        if not m:
            continue
        pre = f"backbone.block{int(m.group(1)) + 1}.{m.group(2)}"
        rest = m.group(3)
        if rest.startswith("attention.self."):
            leaf = rest[len("attention.self."):]
            head = leaf.split(".")[0]
            if head == "query":
                out[pre + ".attn.q." + leaf.split(".")[1]] = v
            elif head in ("key", "value"):
                hp = f"block.{m.group(1)}.{m.group(2)}.attention.self."
                suffix = leaf.split(".")[1]
                if (hp, suffix) not in fused:
                    fused.add((hp, suffix))
                    out[pre + ".attn.kv." + suffix] = np.concatenate(
                        [np.asarray(sd[hp + "key." + suffix]),
                         np.asarray(sd[hp + "value." + suffix])], axis=0
                    )
            elif head == "sr":
                out[pre + ".attn.sr." + leaf.split(".")[1]] = v
            elif head == "layer_norm":
                out[pre + ".attn.norm." + leaf.split(".")[1]] = v
        elif rest.startswith("attention.output.dense."):
            out[pre + ".attn.proj." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("layer_norm_1."):
            out[pre + ".norm1." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("layer_norm_2."):
            out[pre + ".norm2." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("mlp.dense1."):
            out[pre + ".mlp.fc1." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("mlp.dense2."):
            out[pre + ".mlp.fc2." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("mlp.dwconv.dwconv."):
            out[pre + ".mlp.dwconv.dwconv." + rest.rsplit(".", 1)[1]] = v
    return out


def hf_vitdet_to_d2(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF ``VitDetModel`` state dict → the reference's D2 ViTDet
    ``backbone.*`` names (reference backbone/vit.py; HF
    transformers/models/vitdet is an independent port of the same
    upstream ViTDet).  Output feeds convert/d2_mapping.convert_vit_backbone.

    Verified semantic parity points (transformers 4.57 modeling_vitdet.py):
    abs-pos always stores the cls token and strips it (has_cls_token=True,
    bicubic align_corners=False resample — matches models/vit.py
    vit_apply); rel-pos tables resample linearly to 2·max(q,k)−1
    (get_rel_pos ↔ models/vit.py _rel_pos_resampled); the residual
    bottleneck's channel LayerNorms match _ln over NHWC."""
    sd = {
        k.removeprefix("vitdet."): (
            v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        )
        for k, v in sd.items()
    }
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k == "embeddings.position_embeddings":
            out["backbone.pos_embed"] = v
        elif k.startswith("embeddings.projection."):
            out["backbone.patch_embed.proj." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("encoder.layer."):
            i, sub = k[len("encoder.layer."):].split(".", 1)
            if sub.startswith("attention."):
                sub = "attn." + sub[len("attention."):]
            out[f"backbone.blocks.{i}.{sub}"] = v
    return out


def rba_config_from_hf(hf_config):
    """``transformers.Mask2FormerConfig`` (Swin backbone) → RbAConfig.

    Covers the fields that affect forward math; training/eval knobs keep
    the defaults.  HF's ``decoder_layers`` carries the reference's raw
    MASK_FORMER.DEC_LAYERS semantics (HF builds ``decoder_layers - 1``
    layers, mask2former_transformer_decoder.py:388 subtracts 1 the same
    way), so ``DecoderConfig.dec_layers = decoder_layers - 1``."""
    from ..config import DecoderConfig, PixelDecoderConfig, RbAConfig, SwinConfig

    bb = hf_config.backbone_config
    if bb is None or bb.model_type != "swin":
        raise NotImplementedError(
            f"HF backbone {getattr(bb, 'model_type', None)!r}: only Swin-backed "
            "Mask2Former checkpoints map onto the reference's released configs"
        )
    swin = SwinConfig(
        patch_size=bb.patch_size,
        embed_dim=bb.embed_dim,
        depths=tuple(bb.depths),
        num_heads=tuple(bb.num_heads),
        window_size=bb.window_size,
        mlp_ratio=bb.mlp_ratio,
        qkv_bias=bb.qkv_bias,
        ape=bb.use_absolute_embeddings,
        # read, as rba_tpu reads it; neither package's training applies it (ROADMAP.md §C.5)
        drop_path_rate=float(getattr(bb, "drop_path_rate", 0.0)),
    )
    pd = PixelDecoderConfig(
        conv_dim=hf_config.feature_size,
        mask_dim=hf_config.mask_feature_size,
        transformer_in_features=("res3", "res4", "res5"),  # HF hardcodes 3 levels
        transformer_enc_layers=hf_config.encoder_layers,
        transformer_nheads=hf_config.num_attention_heads,
        transformer_dim_feedforward=hf_config.encoder_feedforward_dim,
        common_stride=hf_config.common_stride,
    )
    dec = DecoderConfig(
        hidden_dim=hf_config.hidden_dim,
        num_queries=hf_config.num_queries,
        nheads=hf_config.num_attention_heads,
        dim_feedforward=hf_config.dim_feedforward,
        dec_layers=hf_config.decoder_layers - 1,
        pre_norm=hf_config.pre_norm,
        mask_dim=hf_config.mask_feature_size,
        enforce_input_project=hf_config.enforce_input_projection,
        num_feature_levels=3,
    )
    return RbAConfig(
        backbone_name="swin",
        swin=swin,
        pixel_decoder=pd,
        decoder=dec,
        num_classes=hf_config.num_labels,
        compute_dtype="float32",
        param_dtype="float32",
        pixel_decoder_dtype="float32",
    )


def convert_hf_checkpoint(model_or_state_dict, cfg=None):
    """HF Mask2Former model / state dict → (parameter pytree, cfg); the pytree goes into
    ``build_model(cfg)`` through ``convert.load_jax_params``.

    ``cfg`` defaults to ``rba_config_from_hf(model.config)`` when a model
    object is passed."""
    sd = model_or_state_dict
    if hasattr(sd, "state_dict"):
        model = sd
        if cfg is None:
            cfg = rba_config_from_hf(model.config)
        sd = dict(model.state_dict())
        # HF quirk: Mask2FormerTransformerModule.input_projections is a plain
        # Python list (not nn.ModuleList), so when feature_size != hidden_dim
        # the per-level projection convs never reach the state dict — harvest
        # them from the live module.  (All released facebook/mask2former-*
        # checkpoints use feature_size == hidden_dim, where the projection is
        # an identity Sequential, so hub checkpoints are unaffected.)
        try:
            projs = model.model.transformer_module.input_projections
        except AttributeError:
            projs = []
        for i, p in enumerate(projs):
            if hasattr(p, "weight"):
                sd[f"model.transformer_module.input_projections.{i}.weight"] = p.weight
                if p.bias is not None:
                    sd[f"model.transformer_module.input_projections.{i}.bias"] = p.bias
    if cfg is None:
        raise ValueError("cfg is required when passing a bare state dict")
    from .d2_mapping import convert_d2_state_dict

    return convert_d2_state_dict(hf_mask2former_to_d2(sd), cfg), cfg
