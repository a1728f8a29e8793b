"""PQ of semantic-segmentation predictions (counterpart of
``rba_tpu/tools/evaluate_pq_semseg.py``): each class's region of a class map is one
segment, scored by panoptic quality against the ground truth, in host numpy.

Library use:
    from rba_tpu_torch.tools.evaluate_pq_semseg import semseg_to_panoptic, evaluate
CLI:
    python -m rba_tpu_torch.tools.evaluate_pq_semseg --pred-dir preds/ --gt-dir gts/
(*.png integer class maps with matching file names; 255 = ignore)
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import numpy as np

from ..evalx.panoptic import pq_compute

IGNORE = 255


def semseg_to_panoptic(sem: np.ndarray) -> Tuple[np.ndarray, List[Dict]]:
    """Class map → (panoptic ids, segments): one segment per present class, id = class + 1
    (0 stays void)."""
    pan = np.zeros_like(sem, dtype=np.int32)
    segments = []
    for cls in np.unique(sem):
        if cls == IGNORE:
            continue
        pan[sem == cls] = int(cls) + 1
        segments.append({"id": int(cls) + 1, "category_id": int(cls), "isthing": False})
    return pan, segments


def evaluate(pred_maps, gt_maps) -> Dict:
    pairs = []
    for pred, gt in zip(pred_maps, gt_maps):
        pairs.append((*semseg_to_panoptic(pred), *semseg_to_panoptic(gt)))
    return pq_compute(pairs)


def main(argv=None):
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    args = p.parse_args(argv)

    names = sorted(f for f in os.listdir(args.pred_dir) if f.endswith(".png"))
    preds = [np.asarray(Image.open(os.path.join(args.pred_dir, n))).astype(np.int32) for n in names]
    gts = [np.asarray(Image.open(os.path.join(args.gt_dir, n))).astype(np.int32) for n in names]
    res = evaluate(preds, gts)
    print(f"PQ: {res['All']['pq'] * 100:.2f}  SQ: {res['All']['sq'] * 100:.2f}  "
          f"RQ: {res['All']['rq'] * 100:.2f}  (n={res['All']['n']})")
    return res


if __name__ == "__main__":
    main()
