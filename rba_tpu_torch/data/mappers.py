"""Training mappers: augmentation and padded targets (counterpart of the semantic and
COCO-mix parts of ``rba_tpu/data/mappers.py``).

- ``SemanticDatasetMapper``: ResizeShortestEdge (a random choice of the config's
  scales), RandomCrop, ColorAugSSD, RandomFlip; the semantic map becomes per-class
  binary masks, padded to a static ``max_instances``;
- ``SemanticCocoMixDatasetMapper``: RbA's outlier-exposure mapper: with probability
  ``ood_prob`` a COCO object (label 254) is cut from ``COCOProxyDataset`` and pasted at
  a random place (``mix_object``), and ``outlier_masks`` in {0, 1, 255} is emitted.

Numpy, PIL and ``random.Random``, a copy of ``rba_tpu``'s, so that the same seed gives
the same arrays bit for bit.  The HSV helpers are OpenCV's fixed-point tables, so
``color_aug_ssd`` needs no cv2.

- ``PanopticDatasetMapper`` / ``InstanceDatasetMapper``: the same geometry on a panoptic
  id map (image, ids, segments_info) or an instance mask stack; each segment becomes one
  (class, mask) target, crowds, the ignore class and ``unseen_label_set`` dropped;
- ``PanopticLSJDatasetMapper`` / ``InstanceLSJDatasetMapper`` (``coco_panoptic_lsj``,
  ``coco_instance_lsj``): COCO's large-scale jitter: flip, resize by a scale of a
  square canvas, crop or pad to the canvas (image pad 128, panoptic id 0);
- ``SemanticVoidDatasetMapper``: Cityscapes labelIds, the void classes supervised as
  outliers (``cityscapes_void_lut``), with ``outlier_masks``;
- ``StreetHazardsMapper`` / ``StreetHazardsCocoMixMapper``: StreetHazards' taxonomy
  shift (``street_hazards_shift``) and ignore label 12, plain or with COCO pasting;
- ``load_unseen_label_set``: the open-world protocol's held-out class names → indices.
"""
from __future__ import annotations

import dataclasses
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ood_datasets import rgb2id  # noqa: F401 (the panoptic id decoder, also here as in rba_tpu)

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


# ---------------------------------------------------------------------------
# augmentations (numpy/PIL)
# ---------------------------------------------------------------------------

def resize_shortest_edge(image, sem_seg, target: int, max_size: int):
    h, w = image.shape[:2]
    scale = target / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    img = np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))
    seg = np.asarray(
        Image.fromarray(sem_seg.astype(np.uint8)).resize((nw, nh), Image.NEAREST)
    )
    return img, seg


def random_crop(rng: random.Random, image, sem_seg, crop_hw: Tuple[int, int],
                single_category_max_area: float = 1.0, ignore_label: int = 255):
    """Absolute random crop; with single_category_max_area < 1, retry up to
    10 times until no category covers more than that fraction (D2's
    RandomCrop_CategoryAreaConstraint)."""
    ch, cw = crop_hw
    h, w = image.shape[:2]
    ch, cw = min(ch, h), min(cw, w)
    for _ in range(10):
        y = rng.randint(0, h - ch)
        x = rng.randint(0, w - cw)
        seg = sem_seg[y : y + ch, x : x + cw]
        if single_category_max_area >= 1.0:
            break
        labels, cnt = np.unique(seg, return_counts=True)
        cnt = cnt[labels != ignore_label]
        if len(cnt) > 1 and cnt.max() < single_category_max_area * seg.size:
            break
    return image[y : y + ch, x : x + cw], sem_seg[y : y + ch, x : x + cw]


# cv2 RGB2HSV_b fixed-point tables (hsv_shift = 12): hue/saturation division
# is table-based integer arithmetic, so a float re-derivation is off by one
# LSB on ~2% of pixels.  Replicating the public OpenCV algorithm makes the
# conversion element-exact vs cv2.cvtColor (pinned in
# tests/test_literal_semantics.py against the installed cv2).
_HSV_SHIFT = 12
_SDIV_TABLE = np.zeros(256, np.int64)
_SDIV_TABLE[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256)).astype(np.int64)
_HDIV_TABLE = np.zeros(256, np.int64)
_HDIV_TABLE[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256))).astype(np.int64)


def _rgb_to_hsv_cv2(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB → uint8 HSV with OpenCV conventions: H in [0, 180)
    (degrees/2), S and V in [0, 255] — the color space ColorAugSSDTransform
    operates in (its saturation/hue ops assume cv2 ranges, NOT PIL's
    0..255 hue wheel).  Bit-exact vs ``cv2.cvtColor(x, COLOR_RGB2HSV)``."""
    r, g, b = [rgb[..., i].astype(np.int64) for i in range(3)]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = (diff * _SDIV_TABLE[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(
        v == r, g - b,
        np.where(v == g, b - r + 2 * diff, r - g + 4 * diff),
    )
    h = (h * _HDIV_TABLE[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# OpenCV HSV2RGB sector table: per 60-degree sector, which of
# (v, v(1-s), v(1-s*f), v(1-s*(1-f))) feeds each of (b, g, r)
_SECTOR_DATA = np.array(
    [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]], np.int64
)


def _hsv_to_rgb_cv2(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (cv2 ranges) → uint8 RGB matching
    ``cv2.cvtColor(x, COLOR_HSV2RGB)``: normalized f32 sector kernel with
    TRUNCATING uint8 conversion.  Exactness vs the installed cv2 5.0
    (vectorized build), measured exhaustively over all 180×256×256 valid
    HSV triples: 99.996% bit-exact, the rest ±1 LSB (cv2's SIMD kernel
    fuses one multiply-add we can't express in numpy) — pinned in
    tests/test_literal_semantics.py."""
    ft = np.float32
    h = hsv[..., 0].astype(ft) * ft(6.0 / 180.0)
    s = hsv[..., 1].astype(ft) * ft(1.0 / 255.0)
    v = hsv[..., 2].astype(ft) * ft(1.0 / 255.0)
    h = h - ft(6.0) * np.floor(h / ft(6.0))
    sector = np.minimum(np.floor(h).astype(np.int64), 5)
    f = (h - sector).astype(ft)
    one = ft(1.0)
    tab = np.stack(
        [v,
         (v * (one - s)).astype(ft),
         (v * (one - s * f)).astype(ft),
         (v * (one - (s - s * f))).astype(ft)],
        axis=-1,
    )  # (..., 4)
    bgr_idx = _SECTOR_DATA[sector]  # (..., 3) → indices into tab for (b, g, r)
    bgr = np.take_along_axis(tab, bgr_idx, axis=-1)
    rgb = (bgr[..., ::-1] * ft(255.0)).astype(ft)
    return np.trunc(rgb).clip(0, 255).astype(np.uint8)


def color_aug_ssd(rng: random.Random, image: np.ndarray) -> np.ndarray:
    """SSD-style photometric distortion with the exact semantics of
    point_rend's ColorAugSSDTransform (the class the reference's mappers
    use): brightness delta ±32; contrast ×[0.5, 1.5] applied randomly
    either before or after the saturation+hue pair; saturation scales the
    cv2-HSV S channel; hue shifts the cv2-HSV H channel by an integer in
    [-18, 18] mod 180 (H lives in [0, 180), degrees/2)."""

    def brightness(img):
        if rng.random() < 0.5:
            return np.clip(
                img.astype(np.float32) + rng.uniform(-32, 32), 0, 255
            ).astype(np.uint8)
        return img

    def contrast(img):
        if rng.random() < 0.5:
            return np.clip(
                img.astype(np.float32) * rng.uniform(0.5, 1.5), 0, 255
            ).astype(np.uint8)
        return img

    def saturation(img):
        if rng.random() < 0.5:
            hsv = _rgb_to_hsv_cv2(img)
            hsv[..., 1] = np.clip(
                hsv[..., 1].astype(np.float32) * rng.uniform(0.5, 1.5), 0, 255
            ).astype(np.uint8)
            return _hsv_to_rgb_cv2(hsv)
        return img

    def hue(img):
        if rng.random() < 0.5:
            hsv = _rgb_to_hsv_cv2(img)
            hsv[..., 0] = (
                hsv[..., 0].astype(np.int32) + rng.randint(-18, 18)
            ) % 180
            return _hsv_to_rgb_cv2(hsv)
        return img

    img = brightness(np.asarray(image, np.uint8))
    if rng.random() < 0.5:  # random contrast ordering (ColorAugSSD apply_image)
        img = contrast(img)
        img = saturation(img)
        img = hue(img)
    else:
        img = saturation(img)
        img = hue(img)
        img = contrast(img)
    return img


def extract_bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return 0, 0, 0, 0
    return ys.min(), xs.min(), ys.max() + 1, xs.max() + 1


def mix_object(rng: random.Random, image, sem_seg, obj_image, obj_mask, ood_label: int):
    """Cut the ood-labeled object from (obj_image, obj_mask) and paste it at
    a random location (reference …coco_mix_dataset_mapper.py:55-101)."""
    m = obj_mask == ood_label
    y1, x1, y2, x2 = extract_bbox(m)
    if y2 <= y1 or x2 <= x1:
        return image, sem_seg
    obj_mask = obj_mask[y1:y2, x1:x2]
    obj_image = obj_image[y1:y2, x1:x2]
    oh, ow = obj_mask.shape
    h, w = sem_seg.shape
    if h - oh < 0 or w - ow < 0:
        return image, sem_seg
    hs = rng.randint(0, h - oh)
    ws = rng.randint(0, w - ow)
    out_img = image.copy()
    out_seg = sem_seg.copy()
    sel = obj_mask == ood_label
    out_img[hs : hs + oh, ws : ws + ow][sel] = obj_image[sel]
    out_seg[hs : hs + oh, ws : ws + ow][sel] = ood_label
    return out_img, out_seg


class COCOProxyDataset:
    """COCO images + precomputed OOD-selection binary masks
    (reference data/dataset_mappers/coco.py): ``annotations/
    ood_seg_train2017/*.png`` masks with value 254 on proxy objects."""

    def __init__(self, root: str, proxy_size: Optional[int] = None, seed: int = 0,
                 ood_label: int = 254):
        self.ood_label = ood_label
        ann_root = os.path.join(root, "annotations", "ood_seg_train2017")
        img_root = os.path.join(root, "train2017")
        names = sorted(os.listdir(ann_root))
        rng = random.Random(seed)
        rng.shuffle(names)
        if proxy_size:
            names = names[:proxy_size]
        self.masks = [os.path.join(ann_root, n) for n in names]
        self.images = [os.path.join(img_root, os.path.splitext(n)[0] + ".jpg") for n in names]

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, i):
        img = np.asarray(Image.open(self.images[i]).convert("RGB"))
        mask = np.asarray(Image.open(self.masks[i]))
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        return img, mask.astype(np.int32)


# ---------------------------------------------------------------------------
# mappers
# ---------------------------------------------------------------------------

@dataclass
class MapperConfig:
    min_sizes: Sequence[int] = tuple(int(512 * x / 4) for x in range(4, 17))
    max_size: int = 4096
    crop_hw: Tuple[int, int] = (512, 1024)
    single_category_max_area: float = 1.0
    color_aug: bool = True
    flip: bool = True
    ignore_label: int = 255
    ood_label: int = 254
    size_divisibility: int = -1  # -1: pad to crop size
    max_instances: int = 32  # static target padding: one target shape for every step
    repeat_instance_masks: int = 1  # INPUT.REPEAT_INSTANCE_MASKS


class SemanticDatasetMapper:
    """image + semantic PNG → training example with padded binary masks.

    ``unseen_label_set`` removes classes from supervision (they become
    ignore), the open-world protocol of the reference's open_coco_mapper
    (open_coco_mapper.py:32-36, 210-211)."""

    def __init__(self, cfg: MapperConfig, labels_mapping: Optional[np.ndarray] = None,
                 seed: int = 0, unseen_label_set: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.labels_mapping = labels_mapping
        self.rng = random.Random(seed)
        self.unseen = set(int(c) for c in unseen_label_set) if unseen_label_set else None

    def _augment(self, image, sem_seg):
        c = self.cfg
        target = self.rng.choice(list(c.min_sizes))
        image, sem_seg = resize_shortest_edge(image, sem_seg, target, c.max_size)
        image, sem_seg = random_crop(
            self.rng, image, sem_seg, c.crop_hw, c.single_category_max_area, c.ignore_label
        )
        if c.color_aug:
            image = color_aug_ssd(self.rng, image)
        if c.flip and self.rng.random() < 0.5:
            image = image[:, ::-1]
            sem_seg = sem_seg[:, ::-1]
        return np.ascontiguousarray(image), np.ascontiguousarray(sem_seg)

    def _pad(self, image, sem_seg):
        c = self.cfg
        th, tw = c.crop_hw
        h, w = sem_seg.shape
        ph, pw = max(th - h, 0), max(tw - w, 0)
        if ph or pw:
            image = np.pad(image, ((0, ph), (0, pw), (0, 0)), constant_values=128)
            sem_seg = np.pad(sem_seg, ((0, ph), (0, pw)), constant_values=c.ignore_label)
        return image, sem_seg

    def _build_targets(self, sem_seg):
        c = self.cfg
        classes = np.unique(sem_seg)
        classes = classes[(classes != c.ignore_label) & (classes != c.ood_label)]
        # INPUT.REPEAT_INSTANCE_MASKS: each class mask becomes N identical
        # targets (reference coco_mix mapper :308-313; every shipped config
        # uses 1)
        classes = np.repeat(classes, max(1, c.repeat_instance_masks))
        classes = classes[: c.max_instances]
        t = c.max_instances
        gt_labels = np.zeros((t,), np.int32)
        gt_masks = np.zeros((t,) + sem_seg.shape, np.float32)
        gt_valid = np.zeros((t,), np.float32)
        for i, cls in enumerate(classes):
            gt_labels[i] = cls
            gt_masks[i] = (sem_seg == cls).astype(np.float32)
            gt_valid[i] = 1.0
        return gt_labels, gt_masks, gt_valid

    def __call__(self, image: np.ndarray, sem_seg: np.ndarray) -> Dict[str, np.ndarray]:
        sem_seg = sem_seg.astype(np.int32)
        if self.labels_mapping is not None:
            sem_seg = self.labels_mapping[np.clip(sem_seg, 0, len(self.labels_mapping) - 1)]
        if self.unseen:
            for c in self.unseen:
                sem_seg = np.where(sem_seg == c, self.cfg.ignore_label, sem_seg)
        image, sem_seg = self._augment(image, sem_seg)
        image, sem_seg = self._pad(image, sem_seg)
        gt_labels, gt_masks, gt_valid = self._build_targets(sem_seg)
        return {
            "images": image.astype(np.float32),
            "gt_labels": gt_labels,
            "gt_masks": gt_masks,
            "gt_valid": gt_valid,
            "sem_seg": sem_seg.astype(np.int32),
        }


class SemanticCocoMixDatasetMapper(SemanticDatasetMapper):
    """OOD-finetune mapper: COCO-object pasting + outlier_mask emission."""

    def __init__(self, cfg: MapperConfig, coco_dataset, ood_prob: float = 0.2,
                 labels_mapping: Optional[np.ndarray] = None, seed: int = 0):
        super().__init__(cfg, labels_mapping, seed)
        self.coco = coco_dataset
        self.ood_prob = ood_prob

    def __call__(self, image: np.ndarray, sem_seg: np.ndarray) -> Dict[str, np.ndarray]:
        c = self.cfg
        sem_seg = sem_seg.astype(np.int32)
        if self.labels_mapping is not None and sem_seg.shape != (1024, 2048):
            sem_seg = self.labels_mapping[np.clip(sem_seg, 0, len(self.labels_mapping) - 1)]
        if self.rng.random() < self.ood_prob and len(self.coco) > 0:
            obj_img, obj_mask = self.coco[self.rng.randint(0, len(self.coco) - 1)]
            image, sem_seg = mix_object(self.rng, image, sem_seg, obj_img, obj_mask, c.ood_label)
        image, sem_seg = self._augment(image, sem_seg)
        image, sem_seg = self._pad(image, sem_seg)

        outlier_mask = np.zeros_like(sem_seg)
        outlier_mask[sem_seg == c.ood_label] = 1
        outlier_mask[sem_seg == c.ignore_label] = c.ignore_label

        gt_labels, gt_masks, gt_valid = self._build_targets(sem_seg)
        return {
            "images": image.astype(np.float32),
            "gt_labels": gt_labels,
            "gt_masks": gt_masks,
            "gt_valid": gt_valid,
            "sem_seg": sem_seg.astype(np.int32),
            "outlier_masks": outlier_mask.astype(np.int32),
        }


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ---------------------------------------------------------------------------
# panoptic / instance / LSJ mappers
# ---------------------------------------------------------------------------

class PanopticDatasetMapper(SemanticDatasetMapper):
    """Panoptic training targets (reference mask_former_panoptic_dataset_
    mapper.py): each segment (thing or stuff) becomes one (class, mask) pair.
    Input: image + panoptic id map + segments_info [{id, category_id}]."""

    def __call__(self, image: np.ndarray, pan_seg: np.ndarray,
                 segments_info: List[Dict]) -> Dict[str, np.ndarray]:
        c = self.cfg
        # resize of id maps must preserve exact (possibly >255) ids —
        # use PIL mode "I" nearest instead of the uint8 semantic path
        t = self.rng.choice(list(c.min_sizes))
        h, w = image.shape[:2]
        scale = t / min(h, w)
        if max(h, w) * scale > c.max_size:
            scale = c.max_size / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        image = np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))
        pan = np.asarray(
            Image.fromarray(pan_seg.astype(np.int32), mode="I").resize((nw, nh), Image.NEAREST)
        )
        image, pan = random_crop(self.rng, image, pan, c.crop_hw, 1.0, 0)
        # the reference panoptic mapper reuses the semantic aug list incl.
        # ColorAugSSD (mask_former_panoptic_dataset_mapper.py from_config)
        if c.color_aug:
            image = color_aug_ssd(self.rng, image)
        if c.flip and self.rng.random() < 0.5:
            image = image[:, ::-1]
            pan = pan[:, ::-1]
        image = np.ascontiguousarray(image)
        pan = np.ascontiguousarray(pan)
        # pad
        th, tw = c.crop_hw
        ph, pw = max(th - pan.shape[0], 0), max(tw - pan.shape[1], 0)
        if ph or pw:
            image = np.pad(image, ((0, ph), (0, pw), (0, 0)), constant_values=128)
            pan = np.pad(pan, ((0, ph), (0, pw)), constant_values=0)

        return self._panoptic_example(image, pan, segments_info)

    def _panoptic_example(self, image: np.ndarray, pan: np.ndarray,
                          segments_info: List[Dict]) -> Dict[str, np.ndarray]:
        """Segments → padded (class, mask) targets.  Crowd segments are
        skipped (mask_former_panoptic_dataset_mapper.py:147-151), as is the
        ignore class: the LSJ reference mapper checks class_id != 255
        explicitly (coco_panoptic_new_baseline_dataset_mapper.py:144-148)
        and the open readers emit 255 for unknown things, which must never
        be supervised (the reference's closed panoptic mapper omits the
        check only because its datasets never produce 255); classes in
        ``unseen_label_set`` are dropped from supervision (the open-world
        protocol, open_coco_mapper.py filter_unseen_class)."""
        c = self.cfg
        t_max = c.max_instances
        gt_labels = np.zeros((t_max,), np.int32)
        gt_masks = np.zeros((t_max,) + pan.shape, np.float32)
        gt_valid = np.zeros((t_max,), np.float32)
        i = 0
        for seg in segments_info:
            if seg.get("iscrowd", 0):
                continue
            cls = int(seg["category_id"])
            if cls == c.ignore_label:
                continue
            if self.unseen and cls in self.unseen:
                continue
            m = pan == seg["id"]
            if not m.any() or i >= t_max:
                continue
            gt_labels[i] = cls
            gt_masks[i] = m.astype(np.float32)
            gt_valid[i] = 1.0
            i += 1
        return {
            "images": image.astype(np.float32),
            "gt_labels": gt_labels,
            "gt_masks": gt_masks,
            "gt_valid": gt_valid,
        }


class InstanceDatasetMapper(SemanticDatasetMapper):
    """Instance training targets (reference mask_former_instance_dataset_
    mapper.py): input binary instance masks + classes, augmented jointly."""

    def __call__(self, image: np.ndarray, masks: np.ndarray,
                 classes: np.ndarray) -> Dict[str, np.ndarray]:
        c = self.cfg
        t = self.rng.choice(list(c.min_sizes))
        h, w = image.shape[:2]
        scale = t / min(h, w)
        if max(h, w) * scale > c.max_size:
            scale = c.max_size / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        image = np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))
        masks = np.stack([
            np.asarray(Image.fromarray(m.astype(np.uint8)).resize((nw, nh), Image.NEAREST))
            for m in masks
        ]) if len(masks) else np.zeros((0, nh, nw), np.uint8)
        y = self.rng.randint(0, max(nh - c.crop_hw[0], 0)) if nh > c.crop_hw[0] else 0
        x = self.rng.randint(0, max(nw - c.crop_hw[1], 0)) if nw > c.crop_hw[1] else 0
        ch, cw = min(c.crop_hw[0], nh), min(c.crop_hw[1], nw)
        image = image[y : y + ch, x : x + cw]
        masks = masks[:, y : y + ch, x : x + cw]
        # ColorAugSSD between crop and flip, as in the reference instance
        # mapper's aug list (mask_former_instance_dataset_mapper.py:61-77)
        if c.color_aug:
            image = color_aug_ssd(self.rng, np.ascontiguousarray(image))
        if c.flip and self.rng.random() < 0.5:
            image = image[:, ::-1]
            masks = masks[:, :, ::-1]
        th, tw = c.crop_hw
        ph, pw = max(th - image.shape[0], 0), max(tw - image.shape[1], 0)
        if ph or pw:
            image = np.pad(image, ((0, ph), (0, pw), (0, 0)), constant_values=128)
            masks = np.pad(masks, ((0, 0), (0, ph), (0, pw)))

        t_max = c.max_instances
        gt_labels = np.zeros((t_max,), np.int32)
        gt_masks = np.zeros((t_max, th, tw), np.float32)
        gt_valid = np.zeros((t_max,), np.float32)
        i = 0
        for m, cls in zip(masks, classes):
            if not m.any() or i >= t_max:
                continue
            gt_labels[i] = cls
            gt_masks[i] = m.astype(np.float32)
            gt_valid[i] = 1.0
            i += 1
        return {
            "images": np.ascontiguousarray(image).astype(np.float32),
            "gt_labels": gt_labels,
            "gt_masks": gt_masks,
            "gt_valid": gt_valid,
        }


def lsj_augment(rng: random.Random, image: np.ndarray, sem_seg: np.ndarray,
                image_size: int = 1024, min_scale: float = 0.1, max_scale: float = 2.0,
                ignore_label: int = 255):
    """COCO large-scale-jitter recipe (reference coco_*_new_baseline mappers):
    random resize by scale ∈ [min, max] of a fixed square canvas, then fixed
    crop/pad to (image_size, image_size)."""
    scale = rng.uniform(min_scale, max_scale)
    h, w = image.shape[:2]
    out = image_size
    ratio = out * scale / max(h, w)
    nh, nw = max(int(h * ratio + 0.5), 1), max(int(w * ratio + 0.5), 1)
    img = np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))
    seg = np.asarray(Image.fromarray(sem_seg.astype(np.uint8)).resize((nw, nh), Image.NEAREST))
    y = rng.randint(0, max(nh - out, 0)) if nh > out else 0
    x = rng.randint(0, max(nw - out, 0)) if nw > out else 0
    img = img[y : y + out, x : x + out]
    seg = seg[y : y + out, x : x + out]
    ph, pw = out - img.shape[0], out - img.shape[1]
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), constant_values=128)
        seg = np.pad(seg, ((0, ph), (0, pw)), constant_values=ignore_label)
    return np.ascontiguousarray(img), np.ascontiguousarray(seg.astype(np.int32))


def _lsj_geometry(rng: random.Random, image: np.ndarray,
                  resize_labels, pad_labels, flip_labels,
                  image_size: int, min_scale: float, max_scale: float,
                  flip: bool = True):
    """The COCO large-scale-jitter geometry on an image plus arbitrary
    pixel-aligned labels (reference coco_*_new_baseline build_transform_gen:
    RandomFlip → ResizeScale(scale ∈ [min, max] of an image_size² canvas,
    aspect preserved) → FixedSizeCrop(image_size²)).  The label arrays are
    transformed through the three callbacks so id maps (int32, ids > 255)
    and mask stacks can share the exact same crop/pad offsets.  Image pad
    value 128 matches D2's FixedSizeCrop; label pad is up to ``pad_labels``
    (the reference pads the panoptic RGB png with a constant that decodes
    to a non-segment id)."""
    if flip and rng.random() < 0.5:
        image = image[:, ::-1]
        flip_labels()
    h, w = image.shape[:2]
    scale = rng.uniform(min_scale, max_scale)
    # D2 ResizeScale: output = min(image_size*scale/h, image_size*scale/w)
    ratio = image_size * scale / max(h, w)
    nh, nw = max(int(h * ratio + 0.5), 1), max(int(w * ratio + 0.5), 1)
    image = np.asarray(Image.fromarray(np.ascontiguousarray(image)).resize((nw, nh), Image.BILINEAR))
    resize_labels(nh, nw)
    out = image_size
    y = rng.randint(0, max(nh - out, 0)) if nh > out else 0
    x = rng.randint(0, max(nw - out, 0)) if nw > out else 0
    image = image[y : y + out, x : x + out]
    ph, pw = out - min(nh - y, out), out - min(nw - x, out)
    if ph or pw:
        image = np.pad(image, ((0, ph), (0, pw), (0, 0)), constant_values=128)
    pad_labels(y, x, out, ph, pw)
    return np.ascontiguousarray(image)


class PanopticLSJDatasetMapper(PanopticDatasetMapper):
    """COCO panoptic large-scale-jitter training (reference
    coco_panoptic_new_baseline_dataset_mapper.py, mapper name
    ``coco_panoptic_lsj`` in train_net.py:201-203 — the open-panoptic
    recipe's mapper, Base-COCO-OpenPanopticSegmentation.yaml INPUT)."""

    def __init__(self, cfg: MapperConfig, seed: int = 0, image_size: int = 1024,
                 min_scale: float = 0.1, max_scale: float = 2.0,
                 unseen_label_set: Optional[Sequence[int]] = None):
        super().__init__(cfg, seed=seed, unseen_label_set=unseen_label_set)
        self.image_size = int(image_size)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)

    def __call__(self, image: np.ndarray, pan_seg: np.ndarray,
                 segments_info: List[Dict]) -> Dict[str, np.ndarray]:
        state = {"pan": pan_seg.astype(np.int32)}

        def flip_labels():
            state["pan"] = state["pan"][:, ::-1]

        def resize_labels(nh, nw):
            state["pan"] = np.asarray(Image.fromarray(
                np.ascontiguousarray(state["pan"]), mode="I").resize((nw, nh), Image.NEAREST))

        def pad_labels(y, x, out, ph, pw):
            pan = state["pan"][y : y + out, x : x + out]
            if ph or pw:
                # pad id 0: never a segment id (COCO unlabeled)
                pan = np.pad(pan, ((0, ph), (0, pw)), constant_values=0)
            state["pan"] = pan

        image = _lsj_geometry(
            self.rng, image, resize_labels, pad_labels, flip_labels,
            self.image_size, self.min_scale, self.max_scale, flip=self.cfg.flip,
        )
        return self._panoptic_example(
            image, np.ascontiguousarray(state["pan"]), segments_info
        )


class InstanceLSJDatasetMapper(InstanceDatasetMapper):
    """COCO instance large-scale-jitter training (reference
    coco_instance_new_baseline_dataset_mapper.py, mapper name
    ``coco_instance_lsj`` in train_net.py:197-199).  Input: image + binary
    instance mask stack + classes."""

    def __init__(self, cfg: MapperConfig, seed: int = 0, image_size: int = 1024,
                 min_scale: float = 0.1, max_scale: float = 2.0):
        super().__init__(cfg, seed=seed)
        self.image_size = int(image_size)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)

    def __call__(self, image: np.ndarray, masks: np.ndarray,
                 classes: np.ndarray) -> Dict[str, np.ndarray]:
        state = {"masks": np.asarray(masks, np.uint8)}

        def flip_labels():
            state["masks"] = state["masks"][:, :, ::-1]

        def resize_labels(nh, nw):
            m = state["masks"]
            state["masks"] = np.stack([
                np.asarray(Image.fromarray(np.ascontiguousarray(x)).resize((nw, nh), Image.NEAREST))
                for x in m
            ]) if len(m) else np.zeros((0, nh, nw), np.uint8)

        def pad_labels(y, x, out, ph, pw):
            m = state["masks"][:, y : y + out, x : x + out]
            if ph or pw:
                m = np.pad(m, ((0, 0), (0, ph), (0, pw)))
            state["masks"] = m

        image = _lsj_geometry(
            self.rng, image, resize_labels, pad_labels, flip_labels,
            self.image_size, self.min_scale, self.max_scale, flip=self.cfg.flip,
        )

        c = self.cfg
        t_max = c.max_instances
        gt_labels = np.zeros((t_max,), np.int32)
        gt_masks = np.zeros((t_max, self.image_size, self.image_size), np.float32)
        gt_valid = np.zeros((t_max,), np.float32)
        i = 0
        for m, cls in zip(state["masks"], classes):
            # empty-after-crop instances are dropped (reference
            # utils.filter_empty_instances in the LSJ mapper)
            if not m.any() or i >= t_max:
                continue
            gt_labels[i] = cls
            gt_masks[i] = m.astype(np.float32)
            gt_valid[i] = 1.0
            i += 1
        return {
            "images": image.astype(np.float32),
            "gt_labels": gt_labels,
            "gt_masks": gt_masks,
            "gt_valid": gt_valid,
        }


def load_unseen_label_set(path: str, class_names: Sequence[str]) -> List[int]:
    """DATASETS.UNSEEN_LABEL_SET file → contiguous class indices.  The file
    lists one class NAME per line, resolved against the dataset's class-name
    list (reference open_coco_mapper.py:120-126 _get_unseen_label_set);
    integer lines are taken as indices directly.  Names absent from
    ``class_names`` are skipped with a warning rather than raising — the
    shipped unknown_K*.txt lists are wider than some metadata variants
    (e.g. the open metadata's thing_classes already excludes the unknowns)."""
    idx = {n: i for i, n in enumerate(class_names)}
    out, missing = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.lstrip("-").isdigit():
                out.append(int(line))
            elif line in idx:
                out.append(idx[line])
            else:
                missing.append(line)
    if missing:
        print(f"WARNING: unseen-label names not in class list (skipped): {missing}")
    return out


# ---------------------------------------------------------------------------
# void-as-outlier and StreetHazards train mappers
# ---------------------------------------------------------------------------

def cityscapes_void_lut() -> np.ndarray:
    """Cityscapes labelIds → train ids with void categories supervised as
    OOD (254) rather than ignored, per the reference's void mapper table
    (mask_former_semantic_void_dataset_mapper.py:23-59): true void
    (unlabeled/ego/rectification/out-of-roi/license-plate) → 255; ambiguous
    void (static/dynamic/ground/parking/rail track/guard rail/bridge/tunnel/
    polegroup/caravan/trailer) → 254; the 19 eval classes keep their usual
    train ids."""
    lut = np.full(256, 255, np.int32)
    train = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
             22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
             32: 17, 33: 18}
    ood_ids = (4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30)
    for i, t in train.items():
        lut[i] = t
    for i in ood_ids:
        lut[i] = 254
    return lut


class SemanticVoidDatasetMapper(SemanticDatasetMapper):
    """Void-as-outlier supervision (reference
    mask_former_semantic_void_dataset_mapper.py:68-250): reads raw
    *labelIds* maps, maps void categories to the OOD label via
    cityscapes_void_lut, and emits outlier_masks ∈ {0, 1, 255} so the
    outlier losses can supervise them — no COCO pasting involved."""

    def __init__(self, cfg: MapperConfig, seed: int = 0):
        super().__init__(cfg, labels_mapping=cityscapes_void_lut(), seed=seed)

    def __call__(self, image: np.ndarray, label_ids: np.ndarray) -> Dict[str, np.ndarray]:
        out = super().__call__(image, label_ids)
        sem_seg = out["sem_seg"]
        outlier = np.zeros_like(sem_seg)
        outlier[sem_seg == self.cfg.ood_label] = 1
        outlier[sem_seg == self.cfg.ignore_label] = self.cfg.ignore_label
        out["outlier_masks"] = outlier.astype(np.int32)
        return out


def street_hazards_shift(sem_seg: np.ndarray) -> np.ndarray:
    """The reference's StreetHazards taxonomy shift
    (mask_former_semantic_street_hazards_mapper.py:141-143): labels are
    1-based; subtract 1, relocate class 3 to the end, close the gap.  The
    relocated class ends at 12 (the registered ignore_label), excluding it
    from supervision."""
    x = sem_seg.astype(np.int64) - 1
    x = np.where(x == 3, 13, x)
    x = np.where(x >= 3, x - 1, x)
    return x.astype(np.int32)


class StreetHazardsMapper(SemanticDatasetMapper):
    """StreetHazards train mapper (reference ..._street_hazards_mapper.py):
    the taxonomy shift above, then the standard semantic pipeline with
    ignore_label 12."""

    def __init__(self, cfg: MapperConfig, seed: int = 0):
        cfg = dataclasses.replace(cfg, ignore_label=12)
        super().__init__(cfg, seed=seed)

    def __call__(self, image: np.ndarray, sem_seg: np.ndarray) -> Dict[str, np.ndarray]:
        return super().__call__(image, street_hazards_shift(sem_seg))


class StreetHazardsCocoMixMapper(SemanticCocoMixDatasetMapper):
    """StreetHazards OOD-finetune mapper (reference
    ..._street_hazards_coco_mix_mapper.py): taxonomy shift + COCO-object
    pasting at ood_label, outlier_masks emission."""

    def __init__(self, cfg: MapperConfig, coco_dataset, ood_prob: float = 0.2, seed: int = 0):
        cfg = dataclasses.replace(cfg, ignore_label=12)
        super().__init__(cfg, coco_dataset, ood_prob=ood_prob, seed=seed)

    def __call__(self, image: np.ndarray, sem_seg: np.ndarray) -> Dict[str, np.ndarray]:
        return super().__call__(image, street_hazards_shift(sem_seg))
