"""Panoptic Quality (PQ), with the open-world known / unknown split (counterpart of
``rba_tpu/evalx/panoptic.py``, host numpy as there).

COCO-panoptic PQ: a predicted and a ground-truth segment of one category match when
their IoU (void excluded) is above 0.5; per category PQ = Σ IoU / (TP + FP/2 + FN/2).
The open variant adds the "unknown" category 255, reported on its own.  The per-image
confusion is one ``np.unique`` over the combined (pred_id · OFFSET + gt_id) encoding.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VOID = 0
OFFSET = 256 * 256 * 256
UNKNOWN_CATEGORY = 255


@dataclass
class PQStatCat:
    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0

    def __iadd__(self, other: "PQStatCat"):
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


class PQStat:
    def __init__(self):
        self.per_cat: Dict[int, PQStatCat] = {}

    def __getitem__(self, cat: int) -> PQStatCat:
        return self.per_cat.setdefault(cat, PQStatCat())

    def __setitem__(self, cat: int, value: PQStatCat) -> None:
        self.per_cat[cat] = value

    def __iadd__(self, other: "PQStat"):
        for cat, s in other.per_cat.items():
            self[cat] += s
        return self

    def pq_average(
        self,
        categories: Optional[Sequence[int]] = None,
        isthing: Optional[Dict[int, bool]] = None,
        thing: Optional[bool] = None,
    ) -> Tuple[Dict[str, float], Dict[int, Dict[str, float]]]:
        cats = categories if categories is not None else sorted(self.per_cat)
        pq_sum = sq_sum = rq_sum = 0.0
        n = 0
        per_class = {}
        for cat in cats:
            if isthing is not None and thing is not None:
                if cat not in isthing or isthing[cat] != thing:
                    continue
            s = self.per_cat.get(cat, PQStatCat())
            denom = s.tp + 0.5 * s.fp + 0.5 * s.fn
            if denom == 0:
                per_class[cat] = {"pq": 0.0, "sq": 0.0, "rq": 0.0}
                continue
            n += 1
            pq = s.iou / denom
            sq = s.iou / s.tp if s.tp else 0.0
            rq = s.tp / denom
            per_class[cat] = {"pq": pq, "sq": sq, "rq": rq}
            pq_sum += pq
            sq_sum += sq
            rq_sum += rq
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}, per_class
        return {"pq": pq_sum / n, "sq": sq_sum / n, "rq": rq_sum / n, "n": n}, per_class


def pq_compute_single(
    pan_pred: np.ndarray,  # (H, W) int segment ids, 0 = void
    segments_pred: List[Dict],  # [{"id", "category_id", ...}]
    pan_gt: np.ndarray,
    segments_gt: List[Dict],
    categories: Optional[Dict[int, Dict]] = None,
    strict: bool = False,
) -> PQStat:
    """Per-image PQ confusion, matching panopticapi / the vendored
    reference (evaluation.py:113-218) branch for branch:

    * gt segment areas come from the annotation's ``area`` field when
      present (panopticapi trusts the gt JSON), falling back to pixel
      counts; pred areas are always recomputed from the id map.
    * a gt segment listed in ``segments_gt`` but absent from the id map
      (zero pixels) still counts as FN (evaluation.py:191-199 has no
      area condition).
    * matched TP/IoU and FN double-book under ``original_category_id``
      when present — the open-world relabeling (evaluation.py:180-186,
      :197-199) keeps per-original-class stats for unknown segments.
    * ``strict=True`` reproduces the reference's sanity KeyErrors
      (evaluation.py:135-150): pred id in PNG but not JSON, pred id in
      JSON but not PNG, pred category not in ``categories``.
    * crowd handling: a crowd gt never matches and is not FN; an
      unmatched pred mostly covered by void + the same-category crowd
      region is not FP.  For duplicate same-category crowds the LAST in
      annotation order wins (the reference builds its crowd dict in
      segment order, evaluation.py:195-201).
    """
    stat = PQStat()
    pred_cat = {s["id"]: s["category_id"] for s in segments_pred}
    gt_cat = {s["id"]: s["category_id"] for s in segments_gt}
    gt_orig = {
        s["id"]: s["original_category_id"]
        for s in segments_gt
        if "original_category_id" in s
    }
    gt_crowd = {s["id"] for s in segments_gt if s.get("iscrowd", 0) == 1}
    gt_area_json = {s["id"]: s["area"] for s in segments_gt if "area" in s}

    pan_pred = pan_pred.astype(np.int64)
    pan_gt = pan_gt.astype(np.int64)

    pred_areas = dict(zip(*np.unique(pan_pred, return_counts=True)))
    gt_areas = dict(zip(*np.unique(pan_gt, return_counts=True)))
    gt_areas.update(gt_area_json)  # JSON areas are authoritative when given

    if strict:
        for pid in pred_areas:
            if pid == VOID:
                continue
            if pid not in pred_cat:
                raise KeyError(
                    f"segment ID {pid} is present in the id map and not in "
                    f"segments_info"
                )
            if categories is not None and pred_cat[pid] not in categories:
                raise KeyError(
                    f"segment ID {pid} has unknown category_id {pred_cat[pid]}"
                )
        missing = set(pred_cat) - set(pred_areas)
        if missing:
            raise KeyError(
                f"segment IDs {sorted(missing)} are present in segments_info "
                f"and not in the id map"
            )

    combined = pan_pred * OFFSET + pan_gt
    pairs, counts = np.unique(combined, return_counts=True)
    inter: Dict[Tuple[int, int], int] = {}
    for pair, cnt in zip(pairs, counts):
        inter[(int(pair // OFFSET), int(pair % OFFSET))] = int(cnt)

    matched_pred, matched_gt = set(), set()
    for (pid, gid), cnt in inter.items():
        if pid == VOID or gid == VOID or gid in gt_crowd:
            continue
        if pid not in pred_cat or gid not in gt_cat:
            continue  # ids absent from segments_info never match
        if pred_cat[pid] != gt_cat[gid]:
            continue
        # standard PQ union excludes the pred segment's void overlap
        union = pred_areas[pid] + gt_areas[gid] - cnt - inter.get((pid, VOID), 0)
        iou = cnt / union if union > 0 else 0.0
        if iou > 0.5:
            cat = gt_cat[gid]
            stat[cat].tp += 1
            stat[cat].iou += iou
            if gid in gt_orig:
                stat[gt_orig[gid]].tp += 1
                stat[gt_orig[gid]].iou += iou
            matched_pred.add(pid)
            matched_gt.add(gid)

    for gid, cat in gt_cat.items():
        if gid in matched_gt or gid in gt_crowd:
            continue
        stat[cat].fn += 1
        if gid in gt_orig:
            stat[gt_orig[gid]].fn += 1

    # last same-category crowd wins, in annotation order
    crowd_by_cat = {
        s["category_id"]: s["id"] for s in segments_gt if s.get("iscrowd", 0) == 1
    }
    for pid, cat in pred_cat.items():
        if pid in matched_pred or pid not in pred_areas:
            continue
        # predictions mostly covered by void (+ same-category crowd) don't
        # count as FP (panopticapi rule, reference evaluation.py:190-198)
        void_overlap = inter.get((pid, VOID), 0)
        if cat in crowd_by_cat:
            void_overlap += inter.get((pid, crowd_by_cat[cat]), 0)
        if pred_areas[pid] > 0 and void_overlap / pred_areas[pid] > 0.5:
            continue
        stat[cat].fp += 1
    return stat


def pq_compute(
    pairs: Sequence[Tuple[np.ndarray, List[Dict], np.ndarray, List[Dict]]],
    isthing: Optional[Dict[int, bool]] = None,
    num_workers: int = 0,
) -> Dict[str, Dict]:
    """Aggregate PQ over (pred, pred_segments, gt, gt_segments) image tuples.
    Returns All/Things/Stuff plus Known/Unknown splits (open-world).
    ``num_workers`` > 0 fans the per-image confusion out over a process pool
    (the reference's pq_compute_multi_core, evaluation.py:201-236)."""
    total = PQStat()
    if num_workers > 0 and len(pairs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(num_workers) as pool:
            for stat in pool.starmap(pq_compute_single, pairs):
                total += stat
    else:
        for pan_pred, seg_pred, pan_gt, seg_gt in pairs:
            total += pq_compute_single(pan_pred, seg_pred, pan_gt, seg_gt)

    results: Dict[str, Dict] = {}
    results["All"], per_class = total.pq_average()
    results["per_class"] = per_class
    if isthing is not None:
        results["Things"], _ = total.pq_average(isthing=isthing, thing=True)
        results["Stuff"], _ = total.pq_average(isthing=isthing, thing=False)
    known = [c for c in sorted(total.per_cat) if c != UNKNOWN_CATEGORY]
    results["Known"], _ = total.pq_average(categories=known)
    if UNKNOWN_CATEGORY in total.per_cat:
        results["Unknown"], _ = total.pq_average(categories=[UNKNOWN_CATEGORY])
    return results


def pq_average_open(stat: PQStat, categories: Dict[int, Dict]) -> Dict[str, Dict]:
    """The reference's exact four-way reporting split (evaluation.py:68-110
    and the metrics list at :311-320): **All** (known categories only —
    negative ids and 255 are skipped), **Known Things**, **Unknown Things**
    (only id 255), **Stuff**.  ``categories`` maps id → {"id", "isthing",
    "name"}, i.e. the dict produced by :func:`relabel_unknown_categories`
    for open-world runs or the plain gt categories otherwise."""

    def avg(isthing, isunknown):
        pq = sq = rq = 0.0
        n = 0
        per = {}
        for label, info in categories.items():
            if isthing is not None:
                if (info["isthing"] == 1) != isthing:
                    continue
                cat_isunknown = info["id"] == UNKNOWN_CATEGORY
                if isunknown is None:  # Things: only the mirrored id < -1 skipped
                    if info["id"] < -1:
                        continue
                elif isunknown:  # Unknown Things
                    if not cat_isunknown:
                        continue
                elif info["id"] <= -1 or info["id"] == UNKNOWN_CATEGORY:  # Known
                    continue
            elif info["id"] < 0 or info["id"] == UNKNOWN_CATEGORY:
                continue
            s = stat.per_cat.get(label, PQStatCat())
            if s.tp + s.fp + s.fn == 0:
                per[label] = {"pq": 0.0, "sq": 0.0, "rq": 0.0}
                continue
            denom = s.tp + 0.5 * s.fp + 0.5 * s.fn
            pq_c = s.iou / denom
            sq_c = s.iou / s.tp if s.tp else 0.0
            rq_c = s.tp / denom
            per[label] = {"pq": pq_c, "sq": sq_c, "rq": rq_c}
            n += 1
            pq += pq_c
            sq += sq_c
            rq += rq_c
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}, per
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}, per

    results: Dict[str, Dict] = {}
    for name, isthing, isunknown in (
        ("All", None, None),
        ("Known Things", True, False),
        ("Unknown Things", True, True),
        ("Stuff", False, None),
    ):
        results[name], per = avg(isthing, isunknown)
        if name == "All":
            results["per_class"] = per
    return results


def relabel_unknown_categories(
    categories: Dict[int, Dict],
    annotations: List[Dict],
    unknown_names: Sequence[str],
) -> Dict[int, Dict]:
    """Open-world category surgery (reference evaluation.py:252-280): each
    category whose name is in ``unknown_names`` is removed from the table,
    re-inserted under the mirrored negative id ``-id-1`` as
    ``unknown_<name>``, and a synthetic thing category 255 "unknown" is
    added.  Every gt segment of an unknown category is relabeled in place:
    ``category_id`` → 255, ``original_category_id`` → the mirrored id
    (which :func:`pq_compute_single` double-books TP/IoU/FN under)."""
    unknown_names = set(unknown_names)
    out: Dict[int, Dict] = {}
    unknown_ids = []
    for cid, cat in categories.items():
        if cat["name"] not in unknown_names:
            out[cid] = cat
        else:
            unknown_ids.append(cat["id"])
            mirrored = dict(cat)
            mirrored["supercategory"] = "unknown_" + mirrored.get("supercategory", "")
            mirrored["id"] = -cat["id"] - 1
            mirrored["name"] = "unknown_" + cat["name"]
            out[-cid - 1] = mirrored
    out[UNKNOWN_CATEGORY] = {
        "supercategory": "unknown",
        "isthing": 1,
        "id": UNKNOWN_CATEGORY,
        "name": "unknown",
    }
    unknown_set = set(unknown_ids)
    for ann in annotations:
        for seg in ann["segments_info"]:
            if seg["category_id"] in unknown_set:
                seg["original_category_id"] = -seg["category_id"] - 1
                seg["category_id"] = UNKNOWN_CATEGORY
    return out


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi PNG encoding: id = R + 256·G + 256²·B."""
    color = color.astype(np.uint32)
    if color.ndim == 3:
        return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]
    return color


def id2rgb(idmap: np.ndarray) -> np.ndarray:
    idmap = idmap.astype(np.uint32)
    return np.stack(
        [idmap % 256, (idmap // 256) % 256, (idmap // (256 * 256)) % 256], axis=-1
    ).astype(np.uint8)


def _load_pair(gt_folder, pred_folder, gt_ann, pred_ann, categories, strict):
    from PIL import Image

    pan_gt = rgb2id(np.array(Image.open(os.path.join(gt_folder, gt_ann["file_name"]))))
    pan_pred = rgb2id(
        np.array(Image.open(os.path.join(pred_folder, pred_ann["file_name"])))
    )
    return pq_compute_single(
        pan_pred,
        pred_ann["segments_info"],
        pan_gt,
        gt_ann["segments_info"],
        categories=categories,
        strict=strict,
    )


def pq_compute_dirs(
    gt_json_file: str,
    pred_json_file: str,
    gt_folder: Optional[str] = None,
    pred_folder: Optional[str] = None,
    unknown_label_list: Optional[Sequence[str]] = None,
    num_workers: int = 0,
    strict: bool = True,
) -> Dict[str, Dict]:
    """End-to-end PQ over a real panopticapi-format directory tree — the
    exact on-disk contract of the reference's pq_compute
    (evaluation.py:238-330): a COCO-panoptic gt JSON (``annotations`` with
    per-image ``segments_info``, ``categories``) plus folders of
    rgb2id-encoded PNGs; predictions in the same format.  Raises when a gt
    image has no prediction (reference :299-305), applies the open-world
    ``unknown_label_list`` relabeling, and reports the four-way split."""
    import json

    with open(gt_json_file) as f:
        gt_json = json.load(f)
    with open(pred_json_file) as f:
        pred_json = json.load(f)
    gt_folder = gt_folder or gt_json_file.replace(".json", "")
    pred_folder = pred_folder or pred_json_file.replace(".json", "")
    for d in (gt_folder, pred_folder):
        if not os.path.isdir(d):
            raise FileNotFoundError(f"segmentation folder {d} doesn't exist")

    categories = {c["id"]: c for c in gt_json["categories"]}
    if unknown_label_list is not None:
        categories = relabel_unknown_categories(
            categories, gt_json["annotations"], unknown_label_list
        )

    pred_by_image = {a["image_id"]: a for a in pred_json["annotations"]}
    work = []
    for gt_ann in gt_json["annotations"]:
        if gt_ann["image_id"] not in pred_by_image:
            raise ValueError(
                f"no prediction for the image with id: {gt_ann['image_id']}"
            )
        work.append(
            (gt_folder, pred_folder, gt_ann, pred_by_image[gt_ann["image_id"]],
             categories, strict)
        )

    total = PQStat()
    if num_workers > 0 and len(work) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(num_workers) as pool:
            for stat in pool.starmap(_load_pair, work):
                total += stat
    else:
        for args in work:
            total += _load_pair(*args)
    return pq_average_open(total, categories)
