"""A seeded Detectron2 state dict of a Swin model with any head (the MSDeformAttn or FPN
pixel decoders; the masked, per-pixel, simple or MaskFormer v1 decoder; the per-pixel
baseline heads), in numpy alone (no jax, no torch), so that the CPU tests and
``chip_smoke.py`` make the same released-checkpoint-shaped dict; and its renaming to
HuggingFace's Mask2Former names, with the config of the HF Cityscapes checkpoint."""
from __future__ import annotations

import dataclasses
import re

import numpy as np


def d2_state_dict(cfg, seed: int, pre_rename: bool = True):
    """A seeded Detectron2 state dict of ``cfg``'s Swin / MSDeformAttn / masked-decoder
    model, numpy arrays in torch layouts under the released checkpoints' names: every
    parameter the conversion reads, the buffers it drops (``relative_position_index``,
    the batch norm's ``num_batches_tracked``), the DenseHybrid head where
    ``cfg.decoder.ood_prediction``, and the predictor's input projections where the
    pixel decoder's width is not the decoder's.  With ``pre_rename`` one leaf of each
    historical name: ``static_query`` and a bare ``sem_seg_head.mask_features.weight``.
    Weights ~ N(0, 0.02²), norm scales 1 + N(0, 0.01²), running variances above 1.
    Works from the config's fields alone, so it takes either package's config."""
    rng = np.random.default_rng(seed)
    sd = {}

    def randn(*shape, scale=0.02, shift=0.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)

    def lin(prefix, din, dout, bias=True):
        sd[prefix + ".weight"] = randn(dout, din)
        if bias:
            sd[prefix + ".bias"] = randn(dout)

    def norm(prefix, d):
        sd[prefix + ".weight"] = randn(d, scale=0.01, shift=1.0)
        sd[prefix + ".bias"] = randn(d, scale=0.01)

    def conv(prefix, cin, cout, k, bias=True):
        sd[prefix + ".weight"] = randn(cout, cin, k, k)
        if bias:
            sd[prefix + ".bias"] = randn(cout)

    def mha(prefix, c):
        sd[prefix + ".in_proj_weight"] = randn(3 * c, c)
        sd[prefix + ".in_proj_bias"] = randn(3 * c)
        lin(prefix + ".out_proj", c, c)

    s = cfg.swin
    conv("backbone.patch_embed.proj", 3, s.embed_dim, s.patch_size)
    norm("backbone.patch_embed.norm", s.embed_dim)
    n_rel = (2 * s.window_size - 1) ** 2
    for i in range(s.num_layers):
        dim, hidden = s.stage_dim(i), int(s.stage_dim(i) * s.mlp_ratio)
        for j in range(s.depths[i]):
            pre = f"backbone.layers.{i}.blocks.{j}"
            norm(pre + ".norm1", dim)
            sd[pre + ".attn.relative_position_bias_table"] = randn(n_rel, s.num_heads[i])
            sd[pre + ".attn.relative_position_index"] = (
                np.arange(s.window_size**4, dtype=np.int64).reshape(s.window_size**2, -1) % n_rel)
            lin(pre + ".attn.qkv", dim, 3 * dim)
            lin(pre + ".attn.proj", dim, dim)
            norm(pre + ".norm2", dim)
            lin(pre + ".mlp.fc1", dim, hidden)
            lin(pre + ".mlp.fc2", hidden, dim)
        if i < s.num_layers - 1:
            norm(f"backbone.layers.{i}.downsample.norm", 4 * dim)
            lin(f"backbone.layers.{i}.downsample.reduction", 4 * dim, 2 * dim, bias=False)
        if f"res{i + 2}" in s.out_features:
            norm(f"backbone.norm{i}", dim)

    pd, d = cfg.pixel_decoder, cfg.decoder
    cdim, in_ch = pd.conv_dim, s.out_channels
    pre = "sem_seg_head.pixel_decoder"
    head = getattr(cfg, "sem_seg_head_name", "MaskFormerHead")

    def detr_layers(prefix, n, decoder, c, ffn):
        for i in range(n):
            lp = f"{prefix}.layers.{i}"
            mha(lp + ".self_attn", c)
            norm(lp + ".norm1", c)
            if decoder:
                mha(lp + ".multihead_attn", c)
                norm(lp + ".norm3", c)
            lin(lp + ".linear1", c, ffn)
            lin(lp + ".linear2", ffn, c)
            norm(lp + ".norm2", c)

    def queries_heads(pre, classes=True):
        c = d.hidden_dim
        norm(f"{pre}.decoder_norm", c)
        if classes:
            lin(f"{pre}.class_embed", c, cfg.num_classes + 1)
        for j, dout in enumerate((c, c, d.mask_dim)):
            lin(f"{pre}.mask_embed.layers.{j}", c, dout)

    if pd.name == "MSDeformAttnPixelDecoder":
        for i, f in enumerate(list(pd.transformer_in_features)[::-1]):  # the lowest resolution first
            conv(f"{pre}.input_proj.{i}.0", in_ch[f], cdim, 1)
            norm(f"{pre}.input_proj.{i}.1", cdim)
        sd[f"{pre}.transformer.level_embed"] = randn(pd.num_feature_levels, cdim, scale=1.0)
        n = pd.transformer_nheads * pd.num_feature_levels * pd.enc_n_points
        for i in range(pd.transformer_enc_layers):
            lp = f"{pre}.transformer.encoder.layers.{i}"
            lin(lp + ".self_attn.sampling_offsets", cdim, 2 * n)
            lin(lp + ".self_attn.attention_weights", cdim, n)
            lin(lp + ".self_attn.value_proj", cdim, cdim)
            lin(lp + ".self_attn.output_proj", cdim, cdim)
            norm(lp + ".norm1", cdim)
            lin(lp + ".linear1", cdim, pd.transformer_dim_feedforward)
            lin(lp + ".linear2", pd.transformer_dim_feedforward, cdim)
            norm(lp + ".norm2", cdim)
        for k in range(1, len(pd.in_features) - len(pd.transformer_in_features) + 1):
            conv(f"{pre}.adapter_{k}", in_ch[pd.in_features[k - 1]], cdim, 1, bias=False)
            norm(f"{pre}.adapter_{k}.norm", cdim)
            conv(f"{pre}.layer_{k}", cdim, cdim, 3, bias=False)
            norm(f"{pre}.layer_{k}.norm", cdim)
        conv(f"{pre}.mask_features", cdim, pd.mask_dim, 1)
    else:  # BasePixelDecoder, TransformerEncoderPixelDecoder: adapter_k / layer_k from 1 at the finest
        n, top = len(pd.in_features), pd.in_features[-1]
        encoder = pd.name == "TransformerEncoderPixelDecoder"
        for k in range(1, n + 1):
            if k < n:
                conv(f"{pre}.adapter_{k}", in_ch[pd.in_features[k - 1]], cdim, 1, bias=False)
                norm(f"{pre}.adapter_{k}.norm", cdim)
            conv(f"{pre}.layer_{k}", in_ch[top] if k == n and not encoder else cdim, cdim, 3, bias=False)
            norm(f"{pre}.layer_{k}.norm", cdim)
        conv(f"{pre}.mask_features", cdim, pd.mask_dim, 3)
        if encoder:
            conv(f"{pre}.input_proj", in_ch[top], cdim, 1)
            detr_layers(f"{pre}.transformer.encoder", pd.transformer_enc_layers, False, cdim, d.dim_feedforward)
            if d.pre_norm:
                norm(f"{pre}.transformer.encoder.norm", cdim)

    pre, c = "sem_seg_head.predictor", d.hidden_dim
    if head == "PerPixelBaselineHead":
        conv(pre, pd.mask_dim, cfg.num_classes, 1)
    elif head == "PerPixelBaselinePlusHead" or d.name == "StandardTransformerDecoder":
        width = {"transformer_encoder": cdim, "multi_scale_pixel_decoder": cdim, "pixel_embedding": pd.mask_dim}
        width = width.get(d.transformer_in_feature) or in_ch[d.transformer_in_feature]
        sd[f"{pre}.query_embed.weight"] = randn(d.num_queries, c, scale=1.0)
        if width != c:  # otherwise the projection is an identity without leaves
            conv(f"{pre}.input_proj", width, c, 1)
        detr_layers(f"{pre}.transformer.encoder", d.enc_layers, False, c, d.dim_feedforward)
        detr_layers(f"{pre}.transformer.decoder", d.dec_layers_total, True, c, d.dim_feedforward)
        norm(f"{pre}.transformer.decoder.norm", c)
        if d.pre_norm:
            norm(f"{pre}.transformer.encoder.norm", c)
        if head == "MaskFormerHead":
            lin(f"{pre}.class_embed", c, cfg.num_classes + 1)
        for j, dout in enumerate((c, c, d.mask_dim)):
            lin(f"{pre}.mask_embed.layers.{j}", c, dout)
    else:
        _query_decoder(cfg, sd, randn, mha, norm, lin, conv, queries_heads)
    if d.ood_prediction:
        norm(f"{pre}.ood_pred.norm", c)
        sd[f"{pre}.ood_pred.norm.running_mean"] = randn(c, scale=0.1)
        sd[f"{pre}.ood_pred.norm.running_var"] = 1 + np.abs(randn(c, scale=0.1))
        sd[f"{pre}.ood_pred.norm.num_batches_tracked"] = np.array(1000, np.int64)
        conv(f"{pre}.ood_pred.conv", c, 2, 1)
    if pre_rename:
        if f"{pre}.query_feat.weight" in sd:
            sd[f"{pre}.static_query.weight"] = sd.pop(f"{pre}.query_feat.weight")
        sd["sem_seg_head.mask_features.weight"] = sd.pop("sem_seg_head.pixel_decoder.mask_features.weight")
    return sd


def _query_decoder(cfg, sd, randn, mha, norm, lin, conv, queries_heads):
    """The masked decoder's leaves; the per-pixel decoder's without the class head, the
    simple decoder's (one cross-attention layer, no level embedding) under the same names."""
    d, c, pre = cfg.decoder, cfg.decoder.hidden_dim, "sem_seg_head.predictor"
    simple = d.name in ("SimpleDecoder", "SimpleTransformerDecoder")
    sd[f"{pre}.query_feat.weight"] = randn(d.num_queries, c, scale=1.0)
    sd[f"{pre}.query_embed.weight"] = randn(d.num_queries, c, scale=1.0)
    if not simple:
        sd[f"{pre}.level_embed.weight"] = randn(d.num_feature_levels, c, scale=1.0)
        if cfg.pixel_decoder.conv_dim != c or d.enforce_input_project:
            for i in range(d.num_feature_levels):
                conv(f"{pre}.input_proj.{i}", cfg.pixel_decoder.conv_dim, c, 1)
    for i in range(1 if simple else d.dec_layers):
        mha(f"{pre}.transformer_cross_attention_layers.{i}.multihead_attn", c)
        norm(f"{pre}.transformer_cross_attention_layers.{i}.norm", c)
        if simple:
            continue
        mha(f"{pre}.transformer_self_attention_layers.{i}.self_attn", c)
        norm(f"{pre}.transformer_self_attention_layers.{i}.norm", c)
        lin(f"{pre}.transformer_ffn_layers.{i}.linear1", c, d.dim_feedforward)
        lin(f"{pre}.transformer_ffn_layers.{i}.linear2", d.dim_feedforward, c)
        norm(f"{pre}.transformer_ffn_layers.{i}.norm", c)
    queries_heads(pre, classes=d.name != "MultiScalePerPixelDecoder")


def hf_cityscapes_cfg(base):
    """The architecture of ``facebook/mask2former-swin-base-IN21k-cityscapes-semantic``:
    ``base`` (either package's ``swin_b_1dl()``) with three deformable levels (res3-res5)
    and 9 decoder layers (HF's ``decoder_layers`` 10), 19 classes."""
    return dataclasses.replace(
        base, pixel_decoder=dataclasses.replace(base.pixel_decoder, transformer_in_features=("res3", "res4", "res5")),
        decoder=dataclasses.replace(base.decoder, dec_layers=9, dec_layers_total=10, num_feature_levels=3))


_HF_BB, _HF_PD, _HF_TM = "model.pixel_level_module.encoder.", "model.pixel_level_module.decoder.", "model.transformer_module."
_HF_SWIN = {"norm1": "layernorm_before", "norm2": "layernorm_after", "mlp.fc1": "intermediate.dense",
            "mlp.fc2": "output.dense", "attn.proj": "attention.output.dense",
            "attn.relative_position_bias_table": "attention.self.relative_position_bias_table"}
_HF_ENC = {"norm1": "self_attn_layer_norm", "norm2": "final_layer_norm", "linear1": "fc1", "linear2": "fc2"}


def d2_to_hf_names(sd: dict) -> dict:
    """A Detectron2 state dict of a Swin / MSDeformAttn / masked-decoder model, under the
    current names (``d2_state_dict(..., pre_rename=False)``), renamed to the names of HF's
    ``Mask2FormerForUniversalSegmentation``: the inverse of ``hf_mask2former_to_d2``, with
    the fused qkv and in_proj split into HF's q, k and v projections; buffers dropped.
    HF's model is not needed (nor installed on the card's machine)."""
    out = {}

    def split3(key_fmt, v):
        for part, chunk in zip(("q", "k", "v"), np.split(np.asarray(v), 3, axis=0)):
            out[key_fmt.format(part)] = np.ascontiguousarray(chunk)

    for k, v in sd.items():
        if k.endswith(("relative_position_index", "num_batches_tracked")):
            continue
        leaf = k.rsplit(".", 1)[1]
        if m := re.match(r"backbone\.patch_embed\.(proj|norm)\.", k):
            out[_HF_BB + ("embeddings.patch_embeddings.projection." if m[1] == "proj" else "embeddings.norm.") + leaf] = v
        elif m := re.match(r"backbone\.norm(\d)\.", k):
            out[_HF_BB + f"hidden_states_norms.stage{int(m[1]) + 1}.{leaf}"] = v
        elif m := re.match(r"backbone\.layers\.(\d+)\.downsample\.(.+)$", k):
            out[_HF_BB + f"encoder.layers.{m[1]}.downsample.{m[2]}"] = v
        elif m := re.match(r"backbone\.layers\.(\d+)\.blocks\.(\d+)\.(.+)\.(weight|bias|relative_position_bias_table)$", k):
            pre = _HF_BB + f"encoder.layers.{m[1]}.blocks.{m[2]}."
            part = m[3] if m[4] != "relative_position_bias_table" else m[3] + "." + m[4]
            if part == "attn.qkv":
                for name, chunk in zip(("query", "key", "value"), np.split(np.asarray(v), 3, axis=0)):
                    out[pre + f"attention.self.{name}.{leaf}"] = np.ascontiguousarray(chunk)
            elif part in _HF_SWIN:
                out[pre + _HF_SWIN[part] + ("" if m[4] == "relative_position_bias_table" else "." + leaf)] = v
            else:
                raise KeyError(k)
        elif k == "sem_seg_head.pixel_decoder.transformer.level_embed":
            out[_HF_PD + "level_embed"] = v
        elif k.startswith("sem_seg_head.pixel_decoder.mask_features."):
            out[_HF_PD + "mask_projection." + leaf] = v
        elif m := re.match(r"sem_seg_head\.pixel_decoder\.input_proj\.(\d+)\.([01])\.", k):
            out[_HF_PD + f"input_projections.{m[1]}.{m[2]}.{leaf}"] = v
        elif m := re.match(r"sem_seg_head\.pixel_decoder\.(adapter|layer)_(\d+)\.(norm\.)?(weight|bias)$", k):
            out[_HF_PD + f"{m[1]}_{m[2]}.{1 if m[3] else 0}.{leaf}"] = v
        elif m := re.match(r"sem_seg_head\.pixel_decoder\.transformer\.encoder\.layers\.(\d+)\.(\w+)\.(.+)$", k):
            out[_HF_PD + f"encoder.layers.{m[1]}.{_HF_ENC.get(m[2], m[2])}.{m[3]}"] = v
        elif m := re.match(r"sem_seg_head\.predictor\.(query_embed|query_feat|level_embed)\.weight$", k):
            out[_HF_TM + {"query_embed": "queries_embedder", "query_feat": "queries_features"}.get(m[1], m[1])
                + ".weight"] = v
        elif m := re.match(r"sem_seg_head\.predictor\.input_proj\.(\d+)\.", k):
            out[_HF_TM + f"input_projections.{m[1]}.{leaf}"] = v
        elif k.startswith("sem_seg_head.predictor.decoder_norm."):
            out[_HF_TM + "decoder.layernorm." + leaf] = v
        elif m := re.match(r"sem_seg_head\.predictor\.mask_embed\.layers\.(\d)\.", k):
            out[_HF_TM + f"decoder.mask_predictor.mask_embedder.{m[1]}.0.{leaf}"] = v
        elif k.startswith("sem_seg_head.predictor.class_embed."):
            out["class_predictor." + leaf] = v
        elif m := re.match(r"sem_seg_head\.predictor\.transformer_(cross_attention|self_attention|ffn)_layers\.(\d+)\.(.+)$", k):
            pre, rest = _HF_TM + f"decoder.layers.{m[2]}.", m[3]
            if m[1] == "cross_attention":
                out[pre + ("cross_attn_layer_norm." + leaf if rest.startswith("norm.") else
                           "cross_attn." + rest[len("multihead_attn."):])] = v
            elif m[1] == "self_attention":
                if rest.startswith("norm."):
                    out[pre + "self_attn_layer_norm." + leaf] = v
                elif rest.startswith("self_attn.in_proj_"):
                    split3(pre + "self_attn.{}_proj." + rest.rsplit("_", 1)[1], v)
                else:
                    out[pre + rest] = v
            else:
                out[pre + {"linear1": "fc1", "linear2": "fc2", "norm": "final_layer_norm"}[rest.split(".")[0]]
                    + "." + leaf] = v
        else:
            raise KeyError(f"no HF name for {k}")
    return out
