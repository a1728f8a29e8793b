"""Numerics ablation of the serving modes (counterpart of ``rba_tpu/tools/ablation.py``).

Measures what each precision mode does to the OOD metrics end to end: an independent
torch model at the ``swin_b_1dl()`` architecture (or the tiny test config) is written as
a Detectron2 checkpoint and loaded through the port's production path
(``tools/selfcheck.py``), then a synthetic labeled set is scored under each mode and
AUPRC / AUROC / FPR95 are reported, exact and streamed, with the per-pixel score deltas
from the fp32 torch model's.

Modes (``MODES``):
  fp32       everything fp32
  parity     compute_dtype=bfloat16, pixel_decoder_dtype=float32
  pd_bf16    pixel_decoder_dtype=bfloat16
  fast       pd_bf16 + fast_math=True (bf16 window-attention softmax)
  fast_int8  fast + int8 weights (``ops/quant.py``)
  fast_bf16s fast + the bf16 one-hot deformable sampling

Usage:
    python -m rba_tpu_torch.tools.ablation [--images 50] [--hw 512x1024] [--device cpu] [--tiny]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

MODES = {
    "fp32": dict(compute_dtype="float32", pixel_decoder_dtype="float32", fast_math=False),
    "parity": dict(compute_dtype="bfloat16", pixel_decoder_dtype="float32", fast_math=False),
    "pd_bf16": dict(compute_dtype="bfloat16", pixel_decoder_dtype="bfloat16", fast_math=False),
    "fast": dict(compute_dtype="bfloat16", pixel_decoder_dtype="bfloat16", fast_math=True),
    "fast_int8": dict(compute_dtype="bfloat16", pixel_decoder_dtype="bfloat16", fast_math=True, weight_quant="int8"),
    # fast with PixelDecoderConfig.sampling_dtype="bfloat16", which is nested: set in main()
    "fast_bf16s": dict(compute_dtype="bfloat16", pixel_decoder_dtype="bfloat16", fast_math=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=50)
    ap.add_argument("--hw", default="512x1024")
    ap.add_argument("--dataset", choices=("noise", "structured"), default="noise",
                    help="'structured' composites gradients, textures and objects (SyntheticStructured) instead "
                         "of uniform noise")
    ap.add_argument("--logit_scale", type=float, default=1.0,
                    help="scale the class_embed and mask_embed output heads by this factor before the export, "
                         "pushing softmax / sigmoid / tanh into the saturated regime of trained checkpoints")
    ap.add_argument("--device", default=None, help="the port's torch device (default: the GPU; 'cpu' asks for the CPU)")
    ap.add_argument("--tiny", action="store_true", help="miniature arch (CI smoke)")
    ap.add_argument("--modes", default="parity,pd_bf16,fast")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="write the result JSON here in addition to stdout")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..data.ood_datasets import SyntheticAnomaly, SyntheticStructured
    from ..evalx.evaluator import OODEvaluator
    from ..evalx.sweep import load_model
    from .selfcheck import arch_config, build_torch_model, export_checkpoint, torch_rba_scores

    hw = tuple(int(v) for v in args.hw.split("x"))
    workdir = args.workdir or tempfile.mkdtemp(prefix="rba_ablation_")
    model_dir = os.path.join(workdir, "ckpts", "ablation")
    arch = arch_config("tiny" if args.tiny else "swin_b_1dl")
    swin, pd, dec = build_torch_model(arch)
    if args.logit_scale != 1.0:
        with torch.no_grad():
            for lin in (dec.class_embed, dec.mask_mlp[2]):
                lin.weight.mul_(args.logit_scale)
                lin.bias.mul_(args.logit_scale)
    export_checkpoint(swin, pd, dec, arch, model_dir)
    base_cfg, model = load_model(model_dir, device=args.device)
    ds = (SyntheticStructured if args.dataset == "structured" else SyntheticAnomaly)(n=args.images, hw=hw)

    images = [ds[i].image for i in range(len(ds))]
    ref_scores = torch_rba_scores(swin, pd, dec, base_cfg, images)  # on the CPU
    gts = np.stack([ds[i].label for i in range(len(ds))])
    ref_eval = OODEvaluator(base_cfg, model)
    m_ref = ref_eval.evaluate_ood(ref_scores, gts)

    results = {"reference_torch_fp32": {k: round(100 * v, 4) for k, v in m_ref.items()}}
    for mode in args.modes.split(","):
        cfg = dataclasses.replace(base_cfg, **MODES[mode])
        # load_model's fast_serving sets the nested sampling_dtype to bf16: pin it per mode
        cfg = dataclasses.replace(cfg, pixel_decoder=dataclasses.replace(
            cfg.pixel_decoder, sampling_dtype="bfloat16" if mode == "fast_bf16s" else "float32"))
        ev = OODEvaluator(cfg, model)
        scores, _ = ev.compute_anomaly_scores(ds)
        m_exact = ev.evaluate_ood(scores, gts)
        m_stream = ev.evaluate_dataset(ds)
        results[mode] = {
            "exact": {k: round(100 * v, 4) for k, v in m_exact.items()},
            "streaming": {k: round(100 * v, 4) for k, v in m_stream.items()},
            "delta_vs_torch_pts": {k: round(100 * (m_exact[k] - m_ref[k]), 4) for k in m_exact},
            "score_map_max_abs_delta": float(np.abs(scores - ref_scores).max()),
            "score_map_mean_abs_delta": float(np.abs(scores - ref_scores).mean()),
        }
        print(json.dumps({mode: results[mode]}), flush=True)
        del ev, scores

    out = {"arch": "tiny" if args.tiny else "swin_b_1dl", "hw": list(hw), "n_images": args.images,
           "dataset": args.dataset, "logit_scale": args.logit_scale,
           "device": str(next(model.parameters()).device), "results": results}
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
