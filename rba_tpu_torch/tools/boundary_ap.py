"""Boundary-IoU utilities and boundary mask AP (a copy of ``rba_tpu/tools/boundary_ap.py``,
numpy only).

After the reference's ``tools/evaluate_coco_boundary_ap.py`` (the boundary-IoU COCO API,
Cheng et al. "Boundary IoU: Improving Object-Centric Image Segmentation Evaluation"):
masks are reduced to a boundary band of width d = dilation_ratio·image_diagonal by
erosion, and IoU and AP are computed on the bands.  The erosion is a vectorized numpy
min-filter (no cv2).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _erode(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Binary erosion with a 3×3 structuring element, zero-padded borders
    (matching cv2.erode on a 1-px zero border as used by boundary-IoU)."""
    m = mask.astype(bool)
    for _ in range(iterations):
        p = np.pad(m, 1, constant_values=False)
        m = (
            p[1:-1, 1:-1]
            & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]
            & p[:-2, :-2] & p[:-2, 2:] & p[2:, :-2] & p[2:, 2:]
        )
    return m


def mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    """Boundary band = mask − erode(mask, d), d = ratio·diag."""
    h, w = mask.shape
    d = max(1, round(dilation_ratio * np.sqrt(h * h + w * w)))
    return mask.astype(bool) & ~_erode(mask, d)


def boundary_iou(gt: np.ndarray, pred: np.ndarray, dilation_ratio: float = 0.02) -> float:
    gb = mask_to_boundary(gt, dilation_ratio)
    pb = mask_to_boundary(pred, dilation_ratio)
    inter = (gb & pb).sum()
    union = (gb | pb).sum()
    return float(inter) / max(float(union), 1.0)


def boundary_mask_average_precision(
    predictions: List[Dict[str, np.ndarray]],
    ground_truths: List[Dict[str, np.ndarray]],
    num_classes: int,
    dilation_ratio: float = 0.02,
    iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """Boundary AP: the standard mask-AP machinery with masks replaced by
    their boundary bands."""
    from ..evalx.seg_evaluators import mask_average_precision

    def banded(entries, key):
        out = []
        for e in entries:
            e2 = dict(e)
            e2[key] = np.stack(
                [mask_to_boundary(m, dilation_ratio) for m in e[key]]
            ).astype(np.float32) if len(e[key]) else e[key]
            out.append(e2)
        return out

    return mask_average_precision(
        banded(predictions, "pred_masks"), banded(ground_truths, "masks"),
        num_classes, iou_thresholds,
    )
