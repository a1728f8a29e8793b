"""Semantic, panoptic and instance evaluators (counterpart of ``rba_tpu/evalx/seg_evaluators.py``).

- ``SemSegEvaluator``: the aggregate confusion matrix over a dataset, and mIoU, fwIoU
  and pixel accuracy from it.  The forward is ``maskformer_infer`` (on the card path 1,
  ``attention="fused"``: Kernel A in every Swin block); the argmax and the ``bincount``
  of (label, prediction) pairs run on the model's device, and only the K×K counts come
  back, once, when the evaluation ends.
- ``OpenPanopticEvaluator``: panoptic inference, optionally with the open-world RbA
  branch, into PQ with the known / unknown split (``evalx/panoptic.py``).  The open
  branch's RbA map is Kernel B (``kernels/fused_rba.py``) on the padded low-resolution
  mask logits, cropped, where the mask features are at stride 4 (on the CPU the kernel's
  plain version); at another stride (ViT 16, WiderResNet-38 8), which the kernel's fixed
  ×4 upsample does not fit, it is ``open_rba_map`` of the full-resolution logits, as
  ``rba_tpu`` takes it at every stride.
- ``mask_average_precision``, ``open_world_ap`` and ``InstanceEvaluator``: COCO-style
  mask AP in host numpy, after pycocotools.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import RbAConfig
from ..kernels.fused_rba import fused_rba_score
from ..models.inference import CITYSCAPES_THING_IDS, instance_inference, open_rba_map, panoptic_inference
from ..models.maskformer import maskformer_forward, maskformer_infer, preprocess
from ..ops.resize import resize_bilinear
from .panoptic import UNKNOWN_CATEGORY, pq_compute


def _device(model) -> torch.device:
    return next(model.parameters()).device


def confusion_counts(pred: torch.Tensor, label: torch.Tensor, k: int) -> torch.Tensor:
    """(K, K) int64 counts of (label, prediction) pairs on ``pred``'s device, rows by
    label.  Pixels labelled 255, or with a label outside the K classes, are not counted."""
    label = label.to(pred.device, torch.int64)
    idx = torch.where(label != 255, label * k + pred.to(torch.int64), k * k)
    return torch.bincount(idx.reshape(-1), minlength=k * k + 1)[: k * k].reshape(k, k)


class SemSegEvaluator:
    """Aggregate-confusion-matrix mIoU (plus per-class IoU and pixel accuracy)."""

    def __init__(self, cfg: RbAConfig, model):
        self.cfg = cfg
        self.model = model
        k = cfg.num_classes
        self._conf = torch.zeros((k, k), dtype=torch.int64, device=_device(model))

    @property
    def conf(self) -> np.ndarray:
        return self._conf.cpu().numpy()

    def predict(self, image: np.ndarray) -> torch.Tensor:
        """The (H, W) argmax of the semantic logits of one (H, W, 3) image, on the card."""
        images = torch.from_numpy(np.array(image)[None])
        sem = maskformer_infer(self.model, self.cfg, images)["sem_seg"]
        return sem[0].argmax(0)

    def add(self, pred: torch.Tensor, label: np.ndarray) -> None:
        self._conf += confusion_counts(pred, torch.from_numpy(np.asarray(label)), self.cfg.num_classes)

    def process(self, image: np.ndarray, label: np.ndarray) -> None:
        self.add(self.predict(image), label)

    def evaluate(self) -> Dict[str, float]:
        conf = self.conf.astype(np.float64)
        inter = np.diag(conf)
        union = conf.sum(0) + conf.sum(1) - inter
        iou = inter / np.maximum(union, 1)
        present = union > 0
        freq = conf.sum(1) / max(conf.sum(), 1)
        return {
            "mIoU": float(iou[present].mean()) if present.any() else float("nan"),
            "fwIoU": float((iou * freq).sum()),
            "pACC": float(inter.sum() / max(conf.sum(), 1)),
            "IoU_per_class": iou.tolist(),
        }


class OpenPanopticEvaluator:
    """(Open-)panoptic inference over a dataset with panoptic ground truth, and PQ with
    the Unknown (category 255) split."""

    def __init__(self, cfg: RbAConfig, model, thing_ids: Sequence[int] = CITYSCAPES_THING_IDS,
                 open_panoptic: Optional[bool] = None, ood_threshold: float = -0.1, pixel_min: int = 300):
        self.cfg = cfg
        self.model = model
        self.thing_ids = tuple(thing_ids)
        self.open_panoptic = cfg.test.panoptic_on if open_panoptic is None else open_panoptic
        self.ood_threshold = ood_threshold
        self.pixel_min = pixel_min
        self.pairs: List = []

    @torch.inference_mode()
    def raw_outputs(self, image: np.ndarray):
        """(Q, K+1) class logits, (Q, h, w) mask logits at the mask stride of the padded image, and
        (Q, H, W) mask logits upsampled to the padded size and cropped to the image, all on
        the model's device."""
        images = torch.from_numpy(np.array(image)[None]).to(_device(self.model))
        x = preprocess(self.cfg, images)
        out = maskformer_forward(self.model, self.cfg, x)
        low = out["pred_masks"][0]
        mask_pred = resize_bilinear(low, (x.shape[1], x.shape[2]), align_corners=False)
        return out["pred_logits"][0], low, mask_pred[:, : image.shape[0], : image.shape[1]]

    def rba_map(self, mask_cls: torch.Tensor, low: torch.Tensor, hw, mask_pred: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The open branch's (H, W) RbA map.  At mask stride 4: Kernel B (its plain version
        on the CPU) on the padded low-resolution logits, cropped to ``hw``.  At another
        stride: ``open_rba_map`` of ``mask_pred``, the (Q, H, W) logits at full
        resolution that ``raw_outputs`` returns."""
        if self.model.mask_stride(self.cfg) == 4:
            return fused_rba_score(mask_cls[None], low[None])[0, : hw[0], : hw[1]]
        if mask_pred is None:
            raise ValueError("at a mask stride other than 4 the open branch's map needs the full-resolution mask_pred")
        return open_rba_map(mask_cls, mask_pred)

    def predict(self, image: np.ndarray):
        mask_cls, low, mask_pred = self.raw_outputs(image)
        rba_map = self.rba_map(mask_cls, low, image.shape[:2], mask_pred) if self.open_panoptic else None
        return panoptic_inference(self.cfg, mask_cls, mask_pred, thing_ids=self.thing_ids,
                                  open_panoptic=self.open_panoptic, ood_threshold=self.ood_threshold,
                                  pixel_min=self.pixel_min, rba_map=rba_map)

    def process(self, image: np.ndarray, pan_gt: np.ndarray, segments_gt: List[Dict]):
        pan_pred, segments_pred = self.predict(image)
        self.pairs.append((pan_pred, segments_pred, pan_gt, segments_gt))

    def evaluate(self) -> Dict:
        # every contiguous class is a thing or stuff; unknown segments are things
        things = set(self.thing_ids)
        isthing = {c: c in things for c in range(self.cfg.num_classes)}
        isthing[UNKNOWN_CATEGORY] = True
        return pq_compute(self.pairs, isthing=isthing)


def _mask_iou_matrix(pred_masks: np.ndarray, gt_masks: np.ndarray, iscrowd=None) -> np.ndarray:
    """(P, H, W) × (G, H, W) binary masks → (P, G) IoU.  For a crowd ground truth the
    denominator is the detection's area alone (pycocotools' ``iscrowd``)."""
    p = pred_masks.reshape(len(pred_masks), -1).astype(bool)
    g = gt_masks.reshape(len(gt_masks), -1).astype(bool)
    inter = p.astype(np.float64) @ g.T.astype(np.float64)
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    if iscrowd is not None and np.any(iscrowd):
        parea = np.broadcast_to(p.sum(1)[:, None], union.shape)
        union = np.where(np.asarray(iscrowd, bool)[None, :], parea, union)
    return inter / np.maximum(union, 1)


def mask_average_precision(
    predictions: List[Dict[str, np.ndarray]],  # per image: pred_masks, scores, pred_classes
    ground_truths: List[Dict[str, np.ndarray]],  # per image: masks, classes, [iscrowd]
    num_classes: int,
    # linspace, pycocotools' grid: arange would give 0.60000…01 and reject an IoU of 0.6
    iou_thresholds: Sequence[float] = tuple(np.linspace(0.5, 0.95, 10)),
) -> Dict[str, float]:
    """COCO-style mask AP (mean over IoU 0.5:0.95), as pycocotools' evaluateImg and
    accumulate compute it: detections sorted by descending score with a stable sort,
    per image and over the concatenated records; crowd ground truths are ignore-gts,
    sorted last, never counted, matchable, and a match with one ignores the detection;
    an equal IoU replaces the running best; 101-point interpolated precision."""
    ap_per_thr = []
    for thr in iou_thresholds:
        aps = []
        for cls in range(num_classes):
            records = []  # (score, insertion index, is_tp, is_ignored)
            n_gt = 0
            for pred, gt in zip(predictions, ground_truths):
                gsel = gt["classes"] == cls
                gmasks = gt["masks"][gsel]
                crowd = gt["iscrowd"][gsel].astype(bool) if "iscrowd" in gt else np.zeros(len(gmasks), bool)
                n_gt += int((~crowd).sum())
                psel = pred["pred_classes"] == cls
                pmasks = pred["pred_masks"][psel]
                scores = pred["scores"][psel]
                gorder = np.argsort(crowd, kind="mergesort")
                gmasks, crowd = gmasks[gorder], crowd[gorder]
                dorder = np.argsort(-scores, kind="mergesort")
                iou = _mask_iou_matrix(pmasks, gmasks, iscrowd=crowd) if len(pmasks) and len(gmasks) else None
                matched = np.zeros(len(gmasks), bool)
                for pi in dorder:
                    m = -1
                    best = min(thr, 1 - 1e-10)
                    if iou is not None:
                        for gi in range(len(gmasks)):
                            if matched[gi] and not crowd[gi]:
                                continue
                            # matched to a regular gt already, and only ignore-gts remain
                            if m > -1 and not crowd[m] and crowd[gi]:
                                break
                            if iou[pi, gi] < best:
                                continue
                            best = iou[pi, gi]
                            m = gi
                    if m == -1:
                        records.append((scores[pi], len(records), False, False))
                    else:
                        matched[m] = True
                        records.append((scores[pi], len(records), not crowd[m], bool(crowd[m])))
            if n_gt == 0:
                continue
            if not records:
                aps.append(0.0)
                continue
            records.sort(key=lambda r: (-r[0], r[1]))
            is_tp = np.array([r[2] for r in records])
            is_ig = np.array([r[3] for r in records])
            tps = np.cumsum(is_tp & ~is_ig)
            fps = np.cumsum(~is_tp & ~is_ig)
            recall = tps / n_gt
            precision = tps / (tps + fps + np.spacing(1))
            rc = np.linspace(0, 1, 101)
            prec_interp = np.zeros_like(rc)
            for i in range(len(precision) - 2, -1, -1):  # the precision envelope
                precision[i] = max(precision[i], precision[i + 1])
            idx = np.searchsorted(recall, rc, side="left")
            valid = idx < len(precision)
            prec_interp[valid] = precision[idx[valid]]
            aps.append(float(prec_interp.mean()))
        ap_per_thr.append(float(np.mean(aps)) if aps else float("nan"))
    return {
        "AP": float(np.nanmean(ap_per_thr)),
        "AP50": ap_per_thr[0],
        "AP75": ap_per_thr[5] if len(ap_per_thr) > 5 else float("nan"),
    }


def open_world_ap(
    predictions: List[Dict[str, np.ndarray]],
    ground_truths: List[Dict[str, np.ndarray]],
    unknown_class: int,
) -> Dict[str, float]:
    """The open-world instance AP split: AP over the known classes (unknown instances
    removed on both sides) and class-agnostic AP over the unknown instances alone."""

    def select(items, keep_unknown):
        out = []
        for it in items:
            cls_key = "pred_classes" if "pred_classes" in it else "classes"
            mask_key = "pred_masks" if "pred_masks" in it else "masks"
            cls = it[cls_key]
            sel = (cls == unknown_class) if keep_unknown else (cls != unknown_class)
            d = {mask_key: it[mask_key][sel], cls_key: np.zeros(sel.sum(), np.int64) if keep_unknown else cls[sel]}
            if "scores" in it:
                d["scores"] = it["scores"][sel]
            out.append(d)
        return out

    # over the known ids only: the unknown id (often 255) would make 256 classes of empty work
    n_known = int(max(
        [g["classes"][g["classes"] != unknown_class].max(initial=-1) for g in ground_truths]
        + [p["pred_classes"][p["pred_classes"] != unknown_class].max(initial=-1) for p in predictions])) + 1
    known = mask_average_precision(select(predictions, False), select(ground_truths, False), num_classes=n_known)
    unknown = mask_average_precision(select(predictions, True), select(ground_truths, True), num_classes=1)
    return {"AP_known": known["AP"], "AP50_known": known["AP50"],
            "AP_unknown": unknown["AP"], "AP50_unknown": unknown["AP50"]}


class InstanceEvaluator:
    """Mask AP over a dataset; the forward is an ``OpenPanopticEvaluator``'s."""

    def __init__(self, cfg: RbAConfig, model, topk: int = 100):
        self.cfg = cfg
        self.model = model
        self.topk = topk
        self.preds: List[Dict] = []
        self.gts: List[Dict] = []
        self._fwd = OpenPanopticEvaluator(cfg, model)

    def process(self, image: np.ndarray, gt_masks: np.ndarray, gt_classes: np.ndarray):
        mask_cls, _, mask_pred = self._fwd.raw_outputs(image)
        self.preds.append(instance_inference(self.cfg, mask_cls, mask_pred, topk=self.topk))
        self.gts.append({"masks": gt_masks, "classes": gt_classes})

    def evaluate(self) -> Dict[str, float]:
        return mask_average_precision(self.preds, self.gts, self.cfg.num_classes)
