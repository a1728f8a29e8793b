"""Panoptic, open-panoptic and instance inference heads (counterpart of
``rba_tpu/models/inference.py``).

The dense work runs in torch on the logits' device, the card in an evaluation: the
softmax and sigmoid, the per-pixel argmax over the kept queries' probability masks,
the per-query areas (``bincount`` of the argmax), and for instances the top-k with its
mask scores.  The host reads only what its bookkeeping needs: the (H, W) argmax and
the winner's binary mask as one byte each, the O(Q) areas and labels, and for the open
branch the thresholded RbA map.  ``rba_tpu`` brings the (Q, H, W) mask logits and the
binary masks back instead; the results are the same.  The O(Q) segment-id bookkeeping
and the open branch's morphology and connected components (``scipy.ndimage`` with
cv2's border semantics) run on the host, as there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RbAConfig

# Cityscapes thing classes (contiguous train ids)
CITYSCAPES_THING_IDS = (11, 12, 13, 14, 15, 16, 17, 18)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _panoptic_device(mask_cls: torch.Tensor, mask_pred: torch.Tensor, object_mask_threshold: float):
    """(Q, K+1) class logits and (Q, H, W) mask logits → the kept queries, their labels and
    scores, the (H, W) argmax of the kept queries' probability masks (first index on
    ties, as ``jnp.argmax``), whether each pixel lies in its winner's binary mask, and
    each query's binary, won and final areas.  A query that is not kept gets -1
    everywhere, so the argmax never takes it while another is kept."""
    probs = torch.softmax(mask_cls.float(), dim=-1)
    scores = probs.max(-1).values
    labels = probs.argmax(-1)
    q, num_classes = mask_cls.shape[0], mask_cls.shape[-1] - 1
    keep = (labels != num_classes) & (scores > object_mask_threshold)
    masks = torch.sigmoid(mask_pred.float())
    mask_ids = torch.where(keep[:, None, None], scores[:, None, None] * masks, -1.0).argmax(0)  # (H, W)
    binary = masks >= 0.5
    in_binary = binary.gather(0, mask_ids[None])[0]  # (H, W): the winner's binary mask
    original_area = binary.sum(dim=(1, 2))
    mask_area = torch.bincount(mask_ids.reshape(-1), minlength=q)
    final_area = torch.bincount(mask_ids[in_binary], minlength=q)
    return keep, labels, scores, mask_ids, in_binary, original_area, mask_area, final_area


def _open_binary(ood_binary: np.ndarray) -> np.ndarray:
    """cv2's MORPH_OPEN then MORPH_CLOSE with a 3x3 structure: erosion treats the outside
    as 1 (a region flush against the border survives), dilation as 0."""
    from scipy import ndimage

    structure = np.ones((3, 3), np.uint8)
    ood_binary = ndimage.binary_dilation(
        ndimage.binary_erosion(ood_binary, structure=structure, border_value=1), structure=structure, border_value=0)
    return ndimage.binary_erosion(
        ndimage.binary_dilation(ood_binary, structure=structure, border_value=0), structure=structure,
        border_value=1).astype(np.uint8)


def open_rba_map(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """The plain open-branch score, −Σ_k tanh(Σ_q softmax(cls)[q, k] · sigmoid(mask)[q]),
    of (Q, K+1) class logits and (Q, H, W) mask logits at output resolution."""
    probs = torch.softmax(mask_cls.float(), dim=-1)[:, :-1]
    sem = torch.einsum("qc,qhw->chw", probs, torch.sigmoid(mask_pred.float()))
    return -torch.tanh(sem).sum(0)


def panoptic_inference(
    cfg: RbAConfig,
    mask_cls,  # (Q, K+1): tensor or array
    mask_pred,  # (Q, H, W) logits at output resolution
    thing_ids: Sequence[int] = CITYSCAPES_THING_IDS,
    open_panoptic: Optional[bool] = None,
    ood_threshold: float = -0.1,
    pixel_min: int = 300,
    rba_map=None,  # (H, W) RbA score for the open branch; computed from the logits when None
) -> Tuple[np.ndarray, List[Dict]]:
    """The (H, W) int32 panoptic id map and its segments ({"id", "isthing",
    "category_id"}).  Queries in order: a kept query whose winning pixels cover at least
    ``overlap_threshold`` of its binary mask adds a segment (stuff classes merge into
    one); with ``open_panoptic`` the connected components of the opened and closed
    ``rba_map > ood_threshold`` map that cover at least ``pixel_min`` unlabelled pixels
    become "unknown" segments of category 255."""
    mask_cls, mask_pred = _tensor(mask_cls), _tensor(mask_pred)
    keep, labels, scores, mask_ids, in_binary, orig_area, mask_area, final_area = _panoptic_device(
        mask_cls, mask_pred, cfg.test.object_mask_threshold)
    keep, labels = keep.cpu().numpy(), labels.cpu().numpy()
    orig_area, mask_area, final_area = orig_area.cpu().numpy(), mask_area.cpu().numpy(), final_area.cpu().numpy()
    h, w = mask_pred.shape[-2:]
    panoptic = np.zeros((h, w), np.int32)
    segments: List[Dict] = []
    if not keep.any():
        return panoptic, segments

    # segment id of each query's pixels (0: none), in the reference's query order
    seg_of = np.zeros(mask_pred.shape[0], np.int32)
    current_id = 0
    stuff_memory: Dict[int, int] = {}
    thing_set = set(thing_ids)
    for k in range(mask_pred.shape[0]):
        if not keep[k]:
            continue
        if mask_area[k] <= 0 or orig_area[k] <= 0 or final_area[k] <= 0:
            continue
        if mask_area[k] / orig_area[k] < cfg.test.overlap_threshold:
            continue
        cls = int(labels[k])
        isthing = cls in thing_set
        if not isthing and cls in stuff_memory:
            seg_of[k] = stuff_memory[cls]
            continue
        current_id += 1
        if not isthing:
            stuff_memory[cls] = current_id
        seg_of[k] = current_id
        segments.append({"id": current_id, "isthing": isthing, "category_id": cls})
    # each pixel belongs to one query's mask (its argmax), so the segments never overlap
    ids = mask_ids.to(torch.uint8 if mask_pred.shape[0] <= 256 else torch.int32).cpu().numpy()
    panoptic = np.where(in_binary.cpu().numpy(), seg_of[ids], 0).astype(np.int32)

    if open_panoptic:
        from scipy import ndimage

        if rba_map is None:
            rba_map = open_rba_map(mask_cls, mask_pred)
        ood_binary = _open_binary((_tensor(rba_map) > ood_threshold).to(torch.uint8).cpu().numpy())
        labels_im, num = ndimage.label(ood_binary, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
        for i in range(1, num + 1):  # 4-connectivity, as cv2's connectivity=4
            seg_mask = (labels_im == i) & (panoptic == 0)
            if seg_mask.sum() < pixel_min:
                continue
            current_id += 1
            panoptic[seg_mask] = current_id
            segments.append({"id": current_id, "isthing": True, "category_id": 255})
    return panoptic, segments


def _instance_device(mask_cls: torch.Tensor, mask_pred: torch.Tensor, topk: int, num_classes: int,
                     thing_ids: Optional[Sequence[int]] = None):
    """The top-k (query, class) pairs by class probability (ties: the lower flat index
    first, as ``jax.lax.top_k``, through a stable descending sort), their mask scores
    (the mean sigmoid inside the mask logits' positive part), and with ``thing_ids`` only
    the pairs of those classes.  The binary masks are made once per distinct query."""
    scores = torch.softmax(mask_cls.float(), dim=-1)[:, :-1]
    flat = scores.reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    k = min(topk, flat.numel())  # a small config can have Q·K below the top-k budget
    vals, idx = vals[:k], idx[:k]
    labels, query = idx % num_classes, idx // num_classes
    if thing_ids is not None:
        sel = torch.isin(labels, torch.as_tensor(tuple(thing_ids), device=labels.device))
        vals, labels, query = vals[sel], labels[sel], query[sel]
    uq, inverse = torch.unique(query, return_inverse=True)
    logits = mask_pred[uq].float()
    hard = logits > 0
    mask_scores = (torch.sigmoid(logits) * hard).sum(dim=(1, 2)) / (hard.sum(dim=(1, 2)) + 1e-6)
    return hard, inverse, vals * mask_scores[inverse], labels


def instance_inference(
    cfg: RbAConfig,
    mask_cls,
    mask_pred,  # (Q, H, W) logits at output resolution
    topk: int = 100,
    thing_ids: Sequence[int] = CITYSCAPES_THING_IDS,
) -> Dict[str, np.ndarray]:
    """{"pred_masks": (N, H, W) bool, "scores": (N,) float32, "pred_classes": (N,) int32}
    of the top-k (query, class) pairs; under ``cfg.test.panoptic_on`` only the pairs of
    ``thing_ids``.  ``rba_tpu`` returns the masks as float32 0/1."""
    mask_cls, mask_pred = _tensor(mask_cls), _tensor(mask_pred)
    hard, inverse, scores, labels = _instance_device(
        mask_cls, mask_pred, topk, cfg.num_classes, thing_ids if cfg.test.panoptic_on else None)
    return {"pred_masks": hard.cpu().numpy()[inverse.cpu().numpy()], "scores": scores.cpu().numpy(),
            "pred_classes": labels.to(torch.int32).cpu().numpy()}
