"""Cityscapes-style semantic segmentation evaluation CLI, mIoU (counterpart of
``rba_tpu/evalx/eval_semseg.py``).

The reference scores Cityscapes val with Detectron2's SemSegEvaluator (82.25 mIoU for
``swin_b_1dl`` in its model zoo); this CLI runs that evaluation for a model directory
(``config.yaml`` and ``params.npz`` or a Detectron2 ``model_final.pth``) through
``SemSegEvaluator``: on the card, path 1 (Kernel A in every Swin block), with the
argmax and the confusion counts on the card.

Usage:
    python -m rba_tpu_torch.evalx.eval_semseg --model-dir ckpts/swin_b_1dl \\
        --data-root datasets/cityscapes [--split val] [--limit N] [--out metrics.json] \\
        [--precision fast|parity|fp32] [--device cpu]

It runs on the card unless ``--device`` names another device (``--device cpu``).
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default=None, help="write metrics JSON here")
    p.add_argument("--precision", default="fast", choices=["fast", "parity", "fp32"],
                   help="model numerics, as the sweep's --precision (default fast: fast_serving)")
    p.add_argument("--device", default=None, help="torch device: the GPU by default, 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    from ..data.ood_datasets import CityscapesSemSeg
    from ..models.maskformer import resolve_device
    from .evaluator import prefetch
    from .seg_evaluators import SemSegEvaluator
    from .sweep import load_model

    cfg, model = load_model(args.model_dir, precision=args.precision,
                            device=resolve_device(args.device, "eval_semseg"))
    ds = CityscapesSemSeg(args.data_root, split=args.split)
    limit = args.limit or len(ds)
    ev = SemSegEvaluator(cfg, model)
    for i, sample in enumerate(prefetch(ds, limit)):
        ev.process(sample.image, sample.label)
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{limit}")
    res = ev.evaluate()
    print(json.dumps({k: v for k, v in res.items() if k != "IoU_per_class"}, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
