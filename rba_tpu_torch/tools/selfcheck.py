"""Real-checkpoint parity self-check of the port (counterpart of ``rba_tpu/tools/selfcheck.py``).

Score parity with the released Detectron2 checkpoints needs their ``model_final.pth``
files and the real datasets.  This tool runs the whole parity pipeline without them, so
that once they are there parity is one sweep:

  1. builds an independent torch Mask2Former-style model (``tests/torch_refs.py``, the
     modules that ``rba_tpu``'s selfcheck builds too) at an architecture of the presets
     (``swin_b_1dl()``, ``swin_l_1dl()``) or the tiny test config, and writes its
     weights as a Detectron2 ``model_final.pth`` (``torch.save({"model": state_dict})``)
     beside a Detectron2 ``config.yaml``;
  2. loads that directory through the port's production path (``load_d2_config``,
     ``load_checkpoint_params``'s conversion, ``OODEvaluator``), on the card unless
     ``device`` asks for another;
  3. scores a synthetic labeled set with the torch model (on the CPU) and the port, and
     requires the RbA score maps to agree within ``tol`` (1e-3);
  4. runs the exact metrics both ways and reports the deltas.

``run_metrics_check`` runs the port's sweep CLI end to end over synthetic dataset trees
in the real suites' layouts (``build_synthetic_dataset_trees``).

Usage:
    python -m rba_tpu_torch.tools.selfcheck --tiny --device cpu       # miniature arch (CI)
    python -m rba_tpu_torch.tools.selfcheck --arch swin_b_1dl         # full arch, the port on the GPU
    python -m rba_tpu_torch.tools.selfcheck --metrics --arch tiny --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

#: the architectures of the presets (the released checkpoints' configs; the OOD
#: fine-tunes share the swin_b / swin_l forward architecture)
ARCHS = ("swin_b_1dl", "swin_l_1dl")


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def arch_config(arch: str):
    """The port's config of ``arch``: "tiny" or a preset of ``ARCHS``."""
    from .. import config as tconfig

    if arch == "tiny":  # its encoder FFN at Detectron2's fixed 1024, which a config.yaml cannot change
        c = tconfig.tiny_test_config()
        return dataclasses.replace(c, pixel_decoder=dataclasses.replace(c.pixel_decoder,
                                                                        transformer_dim_feedforward=1024))
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {('tiny',) + ARCHS}")
    return getattr(tconfig, arch)()

def write_d2_config(cfg, path: str) -> None:
    """Emit a minimal Detectron2-format config.yaml describing ``cfg`` — the
    same key schema the released ckpts/*/config.yaml files use, so the
    selfcheck exercises the production ingestion path."""
    import yaml

    d = {
        "MODEL": {
            "BACKBONE": {"NAME": "D2SwinTransformer"},
            "SWIN": {
                "PATCH_SIZE": cfg.swin.patch_size,
                "EMBED_DIM": cfg.swin.embed_dim,
                "DEPTHS": list(cfg.swin.depths),
                "NUM_HEADS": list(cfg.swin.num_heads),
                "WINDOW_SIZE": cfg.swin.window_size,
                "MLP_RATIO": cfg.swin.mlp_ratio,
                "QKV_BIAS": cfg.swin.qkv_bias,
                "APE": cfg.swin.ape,
                "PATCH_NORM": cfg.swin.patch_norm,
                "DROP_PATH_RATE": cfg.swin.drop_path_rate,
                "PRETRAIN_IMG_SIZE": cfg.swin.pretrain_img_size,
                "OUT_FEATURES": list(cfg.swin.out_features),
            },
            "SEM_SEG_HEAD": {
                "NAME": cfg.sem_seg_head_name,
                "NUM_CLASSES": cfg.num_classes,
                "CONVS_DIM": cfg.pixel_decoder.conv_dim,
                "MASK_DIM": cfg.pixel_decoder.mask_dim,
                "NORM": cfg.pixel_decoder.norm,
                "IN_FEATURES": list(cfg.pixel_decoder.in_features),
                "DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES": list(
                    cfg.pixel_decoder.transformer_in_features
                ),
                "TRANSFORMER_ENC_LAYERS": cfg.pixel_decoder.transformer_enc_layers,
                "PIXEL_DECODER_NAME": cfg.pixel_decoder.name,
                "COMMON_STRIDE": cfg.pixel_decoder.common_stride,
            },
            "MASK_FORMER": {
                "HIDDEN_DIM": cfg.decoder.hidden_dim,
                "NUM_OBJECT_QUERIES": cfg.decoder.num_queries,
                "NHEADS": cfg.decoder.nheads,
                "DIM_FEEDFORWARD": cfg.decoder.dim_feedforward,
                "DEC_LAYERS": cfg.decoder.dec_layers + 1,
                "PRE_NORM": cfg.decoder.pre_norm,
                "ENFORCE_INPUT_PROJ": cfg.decoder.enforce_input_project,
                "SIZE_DIVISIBILITY": cfg.input.size_divisibility,
                "TRANSFORMER_DECODER_NAME": cfg.decoder.name,
                "TRANSFORMER_IN_FEATURE": cfg.decoder.transformer_in_feature,
                "TEST": {
                    "SEMANTIC_ON": cfg.test.semantic_on,
                    "PANOPTIC_ON": cfg.test.panoptic_on,
                    "INSTANCE_ON": cfg.test.instance_on,
                },
            },
            "PIXEL_MEAN": list(cfg.input.pixel_mean),
            "PIXEL_STD": list(cfg.input.pixel_std),
        },
        "INPUT": {
            "MIN_SIZE_TEST": cfg.input.min_size_test,
            "MAX_SIZE_TEST": cfg.input.max_size_test,
            "FORMAT": cfg.input.image_format,
            "MIN_SIZE_TRAIN": list(cfg.input.min_size_train),
            "MAX_SIZE_TRAIN": cfg.input.max_size_train,
            "CROP": {
                "ENABLED": cfg.input.crop_enabled,
                "SIZE": list(cfg.input.crop_size),
                "SINGLE_CATEGORY_MAX_AREA": cfg.input.single_category_max_area,
            },
            "COLOR_AUG_SSD": cfg.input.color_aug_ssd,
            "RANDOM_FLIP": "horizontal" if cfg.input.random_flip else "none",
            "SIZE_DIVISIBILITY": cfg.input.train_size_divisibility,
            "DATASET_MAPPER_NAME": cfg.input.dataset_mapper_name,
            "REPEAT_INSTANCE_MASKS": cfg.input.repeat_instance_masks,
            "COCO_ROOT": cfg.input.coco_root,
            "COCO_PROXY_SIZE": cfg.input.coco_proxy_size,
            "IMAGE_SIZE": cfg.input.image_size,
            "MIN_SCALE": cfg.input.min_scale,
            "MAX_SCALE": cfg.input.max_scale,
        },
        "TEST": {
            "EVAL_PERIOD": cfg.test.eval_period,
            "AUG": {
                "ENABLED": cfg.test.aug_enabled,
                "FLIP": cfg.test.aug_flip,
                "MIN_SIZES": list(cfg.test.aug_min_sizes),
                "MAX_SIZE": cfg.test.aug_max_size,
            },
        },
        "DATALOADER": {"NUM_WORKERS": cfg.solver.num_workers},
        "DATASETS": {
            "TRAIN": list(cfg.datasets_train),
            "TEST": list(cfg.datasets_test),
            "UNSEEN_LABEL_SET": cfg.unseen_label_set,
        },
    }
    with open(path, "w") as f:
        yaml.safe_dump(d, f)


def build_torch_model(cfg, seed: int = 0):
    """Torch modules at the dims of ``cfg`` (the modules of the full-scale
    golden, tests/torch_refs.py)."""
    import torch

    sys.path.insert(0, _repo_root())
    from tests.torch_refs import (
        TorchMiniMaskedDecoder,
        TorchPixelDecoderFull,
        TorchSwinFull,
    )

    torch.manual_seed(seed)
    swin = TorchSwinFull(
        embed_dim=cfg.swin.embed_dim, depths=cfg.swin.depths,
        num_heads=cfg.swin.num_heads, window=cfg.swin.window_size,
    )
    with torch.no_grad():
        for stage in swin.blocks:
            for blk in stage:
                blk.attn.relative_position_bias_table.normal_(0, 0.5)
    in_ch = {
        f"res{i + 2}": cfg.swin.embed_dim * 2**i
        for i in range(len(cfg.swin.depths))
    }
    tf = cfg.pixel_decoder.transformer_in_features[-1]
    fpn = tuple(f for f in reversed(cfg.pixel_decoder.in_features) if f != tf)
    pd = TorchPixelDecoderFull(
        in_ch, conv_dim=cfg.pixel_decoder.conv_dim,
        mask_dim=cfg.pixel_decoder.mask_dim,
        enc_layers=cfg.pixel_decoder.transformer_enc_layers,
        nheads=cfg.pixel_decoder.transformer_nheads,
        ffn=cfg.pixel_decoder.transformer_dim_feedforward,
        transformer_feature=tf, fpn_features=fpn,
    )
    with torch.no_grad():
        for l in pd.layers:
            l.attn.sampling_offsets.weight.normal_(0, 0.01)
            l.attn.sampling_offsets.bias.normal_(0, 0.3)
    dec = TorchMiniMaskedDecoder(
        cfg.decoder.hidden_dim, cfg.decoder.nheads, cfg.decoder.dim_feedforward,
        cfg.decoder.dec_layers, cfg.decoder.num_queries, cfg.num_classes,
        cfg.decoder.mask_dim, num_levels=1,
    )
    with torch.no_grad():
        for emb in (dec.query_feat, dec.query_embed, dec.level_embed):
            emb.weight.normal_(0, 0.5)
    return swin, pd, dec


def export_checkpoint(swin, pd, dec, cfg, model_dir: str) -> None:
    """A Detectron2 checkpoint: ``torch.save({"model": state_dict})`` and ``config.yaml``,
    the byte layout of a released ``model_final.pth``."""
    import torch

    sd = export_d2_state_dict(swin, pd, dec, query_feat_key="static_query")
    os.makedirs(model_dir, exist_ok=True)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, os.path.join(model_dir, "model_final.pth"))
    write_d2_config(cfg, os.path.join(model_dir, "config.yaml"))


def export_d2_state_dict(swin, pd, dec, query_feat_key="query_feat"):
    """Map the torch modules' tensors to the reference's D2 names.
    ``query_feat_key="static_query"`` exports the historical pre-rename name
    (mask2former_transformer_decoder.py:237-258)."""
    sd = {}

    def put(name, t):
        sd[name] = t.detach().numpy()

    # ---- backbone ----
    put("backbone.patch_embed.proj.weight", swin.proj.weight)
    put("backbone.patch_embed.proj.bias", swin.proj.bias)
    put("backbone.patch_embed.norm.weight", swin.patch_norm.weight)
    put("backbone.patch_embed.norm.bias", swin.patch_norm.bias)
    for i, stage in enumerate(swin.blocks):
        for j, blk in enumerate(stage):
            pre = f"backbone.layers.{i}.blocks.{j}"
            put(pre + ".norm1.weight", blk.norm1.weight)
            put(pre + ".norm1.bias", blk.norm1.bias)
            put(pre + ".attn.relative_position_bias_table", blk.attn.relative_position_bias_table)
            put(pre + ".attn.qkv.weight", blk.attn.qkv.weight)
            put(pre + ".attn.qkv.bias", blk.attn.qkv.bias)
            put(pre + ".attn.proj.weight", blk.attn.proj.weight)
            put(pre + ".attn.proj.bias", blk.attn.proj.bias)
            put(pre + ".norm2.weight", blk.norm2.weight)
            put(pre + ".norm2.bias", blk.norm2.bias)
            put(pre + ".mlp.fc1.weight", blk.fc1.weight)
            put(pre + ".mlp.fc1.bias", blk.fc1.bias)
            put(pre + ".mlp.fc2.weight", blk.fc2.weight)
            put(pre + ".mlp.fc2.bias", blk.fc2.bias)
        if i < len(swin.blocks) - 1:
            ds = swin.downsamples[i]
            put(f"backbone.layers.{i}.downsample.norm.weight", ds.norm.weight)
            put(f"backbone.layers.{i}.downsample.norm.bias", ds.norm.bias)
            put(f"backbone.layers.{i}.downsample.reduction.weight", ds.reduction.weight)
    for i, n in enumerate(swin.out_norms):
        put(f"backbone.norm{i}.weight", n.weight)
        put(f"backbone.norm{i}.bias", n.bias)

    # ---- pixel decoder ----
    b = "sem_seg_head.pixel_decoder"
    put(b + ".input_proj.0.0.weight", pd.input_proj_conv.weight)
    put(b + ".input_proj.0.0.bias", pd.input_proj_conv.bias)
    put(b + ".input_proj.0.1.weight", pd.input_proj_gn.weight)
    put(b + ".input_proj.0.1.bias", pd.input_proj_gn.bias)
    put(b + ".transformer.level_embed", pd.level_embed)
    for i, l in enumerate(pd.layers):
        pre = f"{b}.transformer.encoder.layers.{i}"
        put(pre + ".self_attn.sampling_offsets.weight", l.attn.sampling_offsets.weight)
        put(pre + ".self_attn.sampling_offsets.bias", l.attn.sampling_offsets.bias)
        put(pre + ".self_attn.attention_weights.weight", l.attn.attention_weights.weight)
        put(pre + ".self_attn.attention_weights.bias", l.attn.attention_weights.bias)
        put(pre + ".self_attn.value_proj.weight", l.attn.value_proj.weight)
        put(pre + ".self_attn.value_proj.bias", l.attn.value_proj.bias)
        put(pre + ".self_attn.output_proj.weight", l.attn.output_proj.weight)
        put(pre + ".self_attn.output_proj.bias", l.attn.output_proj.bias)
        put(pre + ".norm1.weight", l.norm1.weight)
        put(pre + ".norm1.bias", l.norm1.bias)
        put(pre + ".linear1.weight", l.linear1.weight)
        put(pre + ".linear1.bias", l.linear1.bias)
        put(pre + ".linear2.weight", l.linear2.weight)
        put(pre + ".linear2.bias", l.linear2.bias)
        put(pre + ".norm2.weight", l.norm2.weight)
        put(pre + ".norm2.bias", l.norm2.bias)
    if hasattr(pd, "adapters"):  # full layout: adapter_1..n (res2 first)
        for k in range(len(pd.adapters)):
            put(f"{b}.adapter_{k + 1}.weight", pd.adapters[k].weight)
            put(f"{b}.adapter_{k + 1}.norm.weight", pd.adapter_gns[k].weight)
            put(f"{b}.adapter_{k + 1}.norm.bias", pd.adapter_gns[k].bias)
            put(f"{b}.layer_{k + 1}.weight", pd.out_convs[k].weight)
            put(f"{b}.layer_{k + 1}.norm.weight", pd.out_gns[k].weight)
            put(f"{b}.layer_{k + 1}.norm.bias", pd.out_gns[k].bias)
    else:
        put(b + ".adapter_1.weight", pd.adapter_conv.weight)
        put(b + ".adapter_1.norm.weight", pd.adapter_gn.weight)
        put(b + ".adapter_1.norm.bias", pd.adapter_gn.bias)
        put(b + ".layer_1.weight", pd.out_conv.weight)
        put(b + ".layer_1.norm.weight", pd.out_gn.weight)
        put(b + ".layer_1.norm.bias", pd.out_gn.bias)
    put(b + ".mask_features.weight", pd.mask_features.weight)
    put(b + ".mask_features.bias", pd.mask_features.bias)

    # ---- predictor ----
    p = "sem_seg_head.predictor"
    put(f"{p}.{query_feat_key}.weight", dec.query_feat.weight)
    put(p + ".query_embed.weight", dec.query_embed.weight)
    put(p + ".level_embed.weight", dec.level_embed.weight)
    for i in range(dec.num_layers):
        put(f"{p}.transformer_cross_attention_layers.{i}.multihead_attn.in_proj_weight",
            dec.cross_attn[i].in_proj_weight)
        put(f"{p}.transformer_cross_attention_layers.{i}.multihead_attn.in_proj_bias",
            dec.cross_attn[i].in_proj_bias)
        put(f"{p}.transformer_cross_attention_layers.{i}.multihead_attn.out_proj.weight",
            dec.cross_attn[i].out_proj.weight)
        put(f"{p}.transformer_cross_attention_layers.{i}.multihead_attn.out_proj.bias",
            dec.cross_attn[i].out_proj.bias)
        put(f"{p}.transformer_cross_attention_layers.{i}.norm.weight", dec.cross_norm[i].weight)
        put(f"{p}.transformer_cross_attention_layers.{i}.norm.bias", dec.cross_norm[i].bias)
        put(f"{p}.transformer_self_attention_layers.{i}.self_attn.in_proj_weight",
            dec.self_attn[i].in_proj_weight)
        put(f"{p}.transformer_self_attention_layers.{i}.self_attn.in_proj_bias",
            dec.self_attn[i].in_proj_bias)
        put(f"{p}.transformer_self_attention_layers.{i}.self_attn.out_proj.weight",
            dec.self_attn[i].out_proj.weight)
        put(f"{p}.transformer_self_attention_layers.{i}.self_attn.out_proj.bias",
            dec.self_attn[i].out_proj.bias)
        put(f"{p}.transformer_self_attention_layers.{i}.norm.weight", dec.self_norm[i].weight)
        put(f"{p}.transformer_self_attention_layers.{i}.norm.bias", dec.self_norm[i].bias)
        put(f"{p}.transformer_ffn_layers.{i}.linear1.weight", dec.ffn1[i].weight)
        put(f"{p}.transformer_ffn_layers.{i}.linear1.bias", dec.ffn1[i].bias)
        put(f"{p}.transformer_ffn_layers.{i}.linear2.weight", dec.ffn2[i].weight)
        put(f"{p}.transformer_ffn_layers.{i}.linear2.bias", dec.ffn2[i].bias)
        put(f"{p}.transformer_ffn_layers.{i}.norm.weight", dec.ffn_norm[i].weight)
        put(f"{p}.transformer_ffn_layers.{i}.norm.bias", dec.ffn_norm[i].bias)
    put(p + ".decoder_norm.weight", dec.decoder_norm.weight)
    put(p + ".decoder_norm.bias", dec.decoder_norm.bias)
    put(p + ".class_embed.weight", dec.class_embed.weight)
    put(p + ".class_embed.bias", dec.class_embed.bias)
    for j, m in enumerate(dec.mask_mlp):
        put(f"{p}.mask_embed.layers.{j}.weight", m.weight)
        put(f"{p}.mask_embed.layers.{j}.bias", m.bias)
    return sd


def torch_rba_scores(swin, pd, dec, cfg, images) -> "np.ndarray":
    """Reference-semantics RbA scoring of uint8 images on the CPU (normalize → forward →
    mask upsample → softmax⊗sigmoid einsum → -Σ tanh), mirroring the reference's
    evaluate_ood.py:143-150 and maskformer_model.py's eval branch."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, _repo_root())
    from tests.torch_refs import torch_sine_pos_embed

    mean = np.asarray(cfg.input.pixel_mean, np.float32)
    std = np.asarray(cfg.input.pixel_std, np.float32)
    out = []
    with torch.no_grad():
        for img in images:
            h, w = img.shape[:2]
            x = (img.astype(np.float32) - mean) / std
            x = torch.from_numpy(x.transpose(2, 0, 1)[None])
            feats = swin(x)
            mask_features, enc = pd(feats)
            pos = torch_sine_pos_embed(
                enc.shape[2], enc.shape[3], cfg.decoder.hidden_dim // 2
            )
            cls_list, mask_list = dec([enc], [pos], mask_features)
            mask_pred = F.interpolate(
                mask_list[-1], size=(h, w), mode="bilinear", align_corners=False
            )
            probs = torch.softmax(cls_list[-1], dim=-1)[..., :-1]
            sem = torch.einsum("bqc,bqhw->bchw", probs, mask_pred.sigmoid())
            out.append((-sem.tanh().sum(1))[0].numpy())
    return np.stack(out)


def run_selfcheck(workdir: str, arch: str = "tiny", n_images: int = 4, hw=(128, 256), tol: float = 1e-3,
                  device=None) -> dict:
    """One parity run for ``arch`` ("tiny" or one of ``ARCHS``): the torch model on the
    CPU, the port on ``device`` (the card unless the caller asks for another)."""
    import numpy as np

    from ..data.ood_datasets import SyntheticAnomaly
    from ..evalx.evaluator import OODEvaluator
    from ..evalx.sweep import load_model

    arch_cfg = arch_config(arch)
    model_dir = os.path.join(workdir, "ckpts", f"selfcheck_{arch}")
    swin, pd, dec = build_torch_model(arch_cfg)
    export_checkpoint(swin, pd, dec, arch_cfg, model_dir)

    # the production load path: config.yaml and the .pth conversion, at fp32 (parity is
    # the point, not the serving default "fast")
    cfg, model = load_model(model_dir, precision="fp32", device=device)

    ds = SyntheticAnomaly(n=n_images, hw=tuple(hw))
    images = [ds[i].image for i in range(len(ds))]
    rba_torch = torch_rba_scores(swin, pd, dec, cfg, images)

    ev = OODEvaluator(cfg, model)
    scores, gts = ev.compute_anomaly_scores(ds)

    delta = float(np.abs(scores - rba_torch).max())
    m_port = ev.evaluate_ood(scores, gts)
    m_torch = ev.evaluate_ood(rba_torch, gts)
    return {
        "mode": arch,
        "device": str(next(model.parameters()).device),
        "n_images": n_images,
        "hw": list(hw),
        "max_score_delta": delta,
        "tolerance": tol,
        "metrics_port": m_port,
        "metrics_torch": m_torch,
        "metric_deltas": {k: abs(m_port[k] - m_torch[k]) for k in m_port},
        "pass": delta <= tol,
    }


def build_synthetic_dataset_trees(root: str, hw=(256, 512), n: int = 4, seed: int = 0):
    """Write RoadAnomaly / Fishyscapes-LAF / SMIYC-AnomalyTrack directory
    trees — the real suites' on-disk layouts (reference datasets/
    road_anomaly.py, fishyscapes.py, segment_me_if_you_can.py) — filled with
    SyntheticStructured scenes, each label in the suite's native encoding
    (RoadAnomaly marks anomalies 2; the others store {0,1,255} directly).
    Returns the dataset names ``get_datasets(root)`` will discover."""
    import numpy as np
    from PIL import Image

    from ..data.ood_datasets import SyntheticStructured

    ds = SyntheticStructured(n=3 * n, hw=hw, seed=seed)

    def png(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path)

    # RoadAnomaly: frame_list.json + frames/<img>.jpg + <img>.labels/
    ra = os.path.join(root, "RoadAnomaly", "RoadAnomaly_jpg")
    frames = [f"synthetic_{i:02d}.jpg" for i in range(n)]
    os.makedirs(os.path.join(ra, "frames"), exist_ok=True)
    with open(os.path.join(ra, "frame_list.json"), "w") as f:
        json.dump(frames, f)
    for i, fname in enumerate(frames):
        s = ds[i]
        Image.fromarray(s.image).save(os.path.join(ra, "frames", fname), quality=95)
        lab = np.where(s.label == 1, 2, s.label).astype(np.uint8)  # anomaly = 2
        png(os.path.join(ra, "frames", fname[:-4] + ".labels",
                         "labels_semantic.png"), lab)

    # Fishyscapes LAF: label/image pairing via the 0000_-prefixed names
    fs = os.path.join(root, "Fishyscapes")
    for i in range(n):
        s = ds[n + i]
        lbl_name = f"{i:04d}_city_{i:06d}_000019_leftImg8bit.png"
        png(os.path.join(fs, "fishyscapes_lostandfound", lbl_name),
            s.label.astype(np.uint8))
        png(os.path.join(fs, "laf_images", lbl_name[5:-10] + "leftImg8bit.png"),
            s.image)

    # SMIYC AnomalyTrack: validation_* images + labels_masks
    smiyc = os.path.join(root, "SegmentMeIfYouCan", "dataset_AnomalyTrack")
    for i in range(n):
        s = ds[2 * n + i]
        os.makedirs(os.path.join(smiyc, "images"), exist_ok=True)
        Image.fromarray(s.image).save(
            os.path.join(smiyc, "images", f"validation_{i:04d}.jpg"), quality=95)
        png(os.path.join(smiyc, "labels_masks",
                         f"validation_{i:04d}_labels_semantic.png"),
            s.label.astype(np.uint8))

    return ["road_anomaly", "fishyscapes_laf", "road_anomaly_21"]


def run_metrics_check(workdir: str, arch: str = "swin_b_1dl", n_images: int = 4, hw=(256, 512),
                      exact: bool = False, device=None) -> dict:
    """The port's sweep CLI end to end, the command of a real-checkpoint run: synthetic
    dataset trees in the real suites' layouts and the exported ``model_final.pth``,
    producing results.pkl (dataset discovery, the readers, the zoo walk, streaming or
    exact metrics, the results file)."""
    import pickle

    import numpy as np

    from ..evalx.sweep import main as sweep_main

    cfg = arch_config(arch)
    model_dir = os.path.join(workdir, "ckpts", arch)
    if not os.path.exists(os.path.join(model_dir, "model_final.pth")):
        swin, pd, dec = build_torch_model(cfg)
        export_checkpoint(swin, pd, dec, cfg, model_dir)

    data_root = os.path.join(workdir, "datasets")
    names = build_synthetic_dataset_trees(data_root, hw=hw, n=n_images)

    out_path = os.path.join(workdir, "results")
    argv = ["--models_folder", os.path.join(workdir, "ckpts"), "--datasets_folder", data_root,
            "--out_path", out_path, "--dataset_mode", ",".join(names), "--upper_limit", str(n_images)]
    argv += ["--exact"] if exact else []
    argv += ["--device", str(device)] if device is not None else []
    sweep_main(argv)

    pkl = os.path.join(out_path, arch, "results.pkl")
    ok = os.path.exists(pkl)
    rows = {}
    if ok:
        with open(pkl, "rb") as f:
            rows = pickle.load(f)
    return {
        "mode": "metrics",
        "arch": arch,
        "datasets": names,
        "results_pkl": pkl,
        "rows": {k: {m: round(float(x), 4) for m, x in v.items()} for k, v in rows.items()},
        "pass": ok and set(rows) >= set(names) and all(all(np.isfinite(list(v.values()))) for v in rows.values()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None, help="scratch dir for the exported checkpoint (default: tmp)")
    ap.add_argument("--tiny", action="store_true", help="miniature architecture (seconds instead of minutes)")
    ap.add_argument("--arch", default=None, choices=("tiny", "all") + ARCHS,
                    help="preset architecture to check (or 'all'); default swin_b_1dl")
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--hw", default=None, help="synthetic image HxW")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="the port's torch device (default: the GPU; 'cpu' asks for the CPU)")
    ap.add_argument("--metrics", action="store_true",
                    help="instead of score-map parity, run the sweep CLI end to end over synthetic "
                         "RoadAnomaly / Fishyscapes-LAF / SMIYC dataset trees")
    ap.add_argument("--exact", action="store_true", help="with --metrics: all-pixel exact metrics")
    args = ap.parse_args(argv)

    arch = args.arch or ("tiny" if args.tiny else "swin_b_1dl")
    hw = tuple(int(v) for v in args.hw.split("x")) if args.hw else ((64, 96) if arch == "tiny" else (128, 256))
    workdir = args.workdir or tempfile.mkdtemp(prefix="rba_selfcheck_")
    results = []
    for a in (ARCHS if arch == "all" else (arch,)):
        if args.metrics:
            result = run_metrics_check(workdir, a, args.images, hw, exact=args.exact, device=args.device)
        else:
            result = run_selfcheck(workdir, a, args.images, hw, args.tol, device=args.device)
        print(json.dumps(result, indent=2))
        results.append(result)
    failed = [r for r in results if not r["pass"]]
    if failed:
        raise SystemExit("selfcheck FAILED: " + ", ".join(
            f"{r['mode']} delta {r.get('max_score_delta', float('nan')):.2e} > {r.get('tolerance')}" for r in failed))
    print(f"selfcheck PASS ({len(results)} arch(s))")
    return results


if __name__ == "__main__":
    main()
