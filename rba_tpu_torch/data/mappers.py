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
``color_aug_ssd`` needs no cv2.  The panoptic, instance, LSJ, void and StreetHazards
mappers are not ported yet (ROADMAP.md §A.4).
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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
