"""A seeded Detectron2 state dict of a Swin / MSDeformAttn / masked-decoder model, in
numpy alone (no jax, no torch), so that the CPU tests and ``chip_smoke.py`` make the
same released-checkpoint-shaped dict."""
from __future__ import annotations

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

    pre, c = "sem_seg_head.predictor", d.hidden_dim
    sd[f"{pre}.query_feat.weight"] = randn(d.num_queries, c, scale=1.0)
    sd[f"{pre}.query_embed.weight"] = randn(d.num_queries, c, scale=1.0)
    sd[f"{pre}.level_embed.weight"] = randn(d.num_feature_levels, c, scale=1.0)
    if cdim != c or d.enforce_input_project:
        for i in range(d.num_feature_levels):
            conv(f"{pre}.input_proj.{i}", cdim, c, 1)
    for i in range(d.dec_layers):
        mha(f"{pre}.transformer_cross_attention_layers.{i}.multihead_attn", c)
        norm(f"{pre}.transformer_cross_attention_layers.{i}.norm", c)
        mha(f"{pre}.transformer_self_attention_layers.{i}.self_attn", c)
        norm(f"{pre}.transformer_self_attention_layers.{i}.norm", c)
        lin(f"{pre}.transformer_ffn_layers.{i}.linear1", c, d.dim_feedforward)
        lin(f"{pre}.transformer_ffn_layers.{i}.linear2", d.dim_feedforward, c)
        norm(f"{pre}.transformer_ffn_layers.{i}.norm", c)
    norm(f"{pre}.decoder_norm", c)
    lin(f"{pre}.class_embed", c, cfg.num_classes + 1)
    for j, dout in enumerate((c, c, d.mask_dim)):
        lin(f"{pre}.mask_embed.layers.{j}", c, dout)
    if d.ood_prediction:
        norm(f"{pre}.ood_pred.norm", c)
        sd[f"{pre}.ood_pred.norm.running_mean"] = randn(c, scale=0.1)
        sd[f"{pre}.ood_pred.norm.running_var"] = 1 + np.abs(randn(c, scale=0.1))
        sd[f"{pre}.ood_pred.norm.num_batches_tracked"] = np.array(1000, np.int64)
        conv(f"{pre}.ood_pred.conv", c, 2, 1)
    if pre_rename:
        sd[f"{pre}.static_query.weight"] = sd.pop(f"{pre}.query_feat.weight")
        sd["sem_seg_head.mask_features.weight"] = sd.pop("sem_seg_head.pixel_decoder.mask_features.weight")
    return sd
