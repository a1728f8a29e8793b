"""OOD evaluation dataset readers (counterpart of ``rba_tpu/data/ood_datasets.py``).

The readers the sweep needs, after the reference RbA code's ``datasets/`` classes
as its ``support.get_datasets`` builds them: RoadAnomaly (label 2 → 1),
Fishyscapes LAF and Static v1/v2, the SegmentMeIfYouCan tracks (AnomalyTrack
resized to 720×1280; ObstacleTrack with webp images), LostAndFound (labels
1 → 0, 2 → 1), Cityscapes val (trainIds) and BDD100K, plus the procedural
``SyntheticAnomaly`` and ``SyntheticStructured``; StreetHazards, Small Obstacles,
Cityscapes-C and incremental-class Cityscapes; the COCO-format panoptic ground truth of
the closed-set evaluation (``PanopticDataset``) with its instance and semantic views
(``InstanceFromPanoptic``, ``SemSegFromPanoptic``); and the training readers:
Mapillary Vistas (``MapillarySemSeg``, in its own or the Cityscapes taxonomy), a
label folder (``SemSegFolder``) and the union of several (``ConcatDataset``).

Label convention of the OOD readers: 0 = inlier, 1 = anomaly, 255 = ignore.  The readers
return numpy (uint8 RGB image, int32 label); batching and uploads are the
evaluator's job.  PIL is needed only to read image files.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def _read_image(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def _read_label(path: str) -> np.ndarray:
    arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr.astype(np.int32)


def _resize_pair(image, label, hw):
    h, w = hw
    img = np.asarray(Image.fromarray(image).resize((w, h), Image.BILINEAR), np.uint8)
    lab = np.asarray(
        Image.fromarray(label.astype(np.uint8)).resize((w, h), Image.NEAREST), np.int32
    )
    return img, lab


@dataclass
class Sample:
    image: np.ndarray  # (H, W, 3) uint8
    label: np.ndarray  # (H, W) int32 {0, 1, 255}
    name: str


class OODDataset:
    """Base: a list of (image_path, label_path) + a label remap function."""

    name = "base"

    def __init__(self):
        self.images: List[str] = []
        self.labels: List[str] = []
        self.resize_to: Optional[Tuple[int, int]] = None

    def __len__(self):
        return len(self.images)

    def _remap(self, label: np.ndarray) -> np.ndarray:
        return label

    def __getitem__(self, i: int) -> Sample:
        image = _read_image(self.images[i])
        label = self._remap(_read_label(self.labels[i]))
        if self.resize_to is not None:
            image, label = _resize_pair(image, label, self.resize_to)
        return Sample(image, label, os.path.basename(self.images[i]))

    def __iter__(self) -> Iterator[Sample]:
        for i in range(len(self)):
            yield self[i]


class ConcatDataset(OODDataset):
    """The union of several readers, indexed part after part: DATASETS.TRAIN may list
    several names, and the reference trains on the union of their catalog entries (the
    Mapillary fine-tunes list ``mapillary_cityscapes_sem_seg_train`` and
    ``cityscapes_fine_sem_seg_train``)."""

    name = "concat"

    def __init__(self, parts):
        super().__init__()
        self.parts = list(parts)
        self._offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, i: int):
        j = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self.parts[j][int(i) - int(self._offsets[j])]


class RoadAnomaly(OODDataset):
    """frame_list.json + frames/<img> + frames/<img>.labels/labels_semantic.png;
    label 2 (ignore convention of the raw data) maps to anomaly=1."""

    name = "road_anomaly"

    def __init__(self, root: str):
        super().__init__()
        with open(os.path.join(root, "frame_list.json")) as f:
            frames = json.load(f)
        for fname in frames:
            self.images.append(os.path.join(root, "frames", fname))
            self.labels.append(
                os.path.join(root, "frames", fname[:-4] + ".labels", "labels_semantic.png")
            )

    def _remap(self, label):
        return np.where(label == 2, 1, label).astype(np.int32)


class FishyscapesLAF(OODDataset):
    """fishyscapes_lostandfound/<label>.png + laf_images/<id>leftImg8bit.png."""

    name = "fishyscapes_laf"

    def __init__(self, root: str):
        super().__init__()
        labels_path = os.path.join(root, "fishyscapes_lostandfound")
        for lbl in sorted(os.listdir(labels_path)):
            self.labels.append(os.path.join(labels_path, lbl))
            self.images.append(os.path.join(root, "laf_images", lbl[5:-10] + "leftImg8bit.png"))


class FishyscapesStatic(OODDataset):
    name = "fs_static"

    def __init__(self, root: str, version: int = 1):
        super().__init__()
        if version not in (1, 2):
            raise ValueError(f"FishyscapesStatic versions are 1/2, got {version}")
        if version == 2:
            self.name = "fs_static_v2"
        labels_root = os.path.join(root, f"fs_val_v{version}")
        images_root = os.path.join(root, f"fs_static_images_v{version}")
        for f in sorted(os.listdir(labels_root)):
            if not f.endswith("png"):
                continue
            self.labels.append(os.path.join(labels_root, f))
            self.images.append(os.path.join(images_root, f[:-10] + "rgb.png"))


class _SMIYC(OODDataset):
    """SegmentMeIfYouCan track: images/ + labels_masks/; 'validation' files
    have labels, the rest are held-out test."""

    label_suffix_strip = 4  # strip ".png"

    def __init__(self, root: str, mode: str = "val"):
        super().__init__()
        images_root = os.path.join(root, "images")
        labels_root = os.path.join(root, "labels_masks")
        files = sorted(os.listdir(images_root))
        for f in files:
            is_val = "validation" in f
            if mode == "val" and not is_val:
                continue
            if mode == "test" and is_val:
                continue
            self.images.append(os.path.join(images_root, f))
            if is_val:
                self.labels.append(
                    os.path.join(
                        labels_root, f[: -self.label_suffix_strip] + "_labels_semantic.png"
                    )
                )
            else:
                self.labels.append("")

    def __getitem__(self, i: int) -> Sample:
        image = _read_image(self.images[i])
        if self.labels[i]:
            label = self._remap(_read_label(self.labels[i]))
        else:
            label = np.zeros(image.shape[:2], np.int32)
        if self.resize_to is not None:
            image, label = _resize_pair(image, label, self.resize_to)
        return Sample(image, label, os.path.basename(self.images[i]))


class RoadAnomaly21(_SMIYC):
    """SMIYC AnomalyTrack; evaluated at 720×1280, as the reference evaluates it."""

    name = "road_anomaly_21"
    label_suffix_strip = 4  # .jpg

    def __init__(self, root: str, mode: str = "val", resize_to=(720, 1280)):
        super().__init__(root, mode)
        self.resize_to = resize_to


class RoadObstacle21(_SMIYC):
    """SMIYC ObstacleTrack; .webp images (PIL decodes webp natively)."""

    name = "road_obstacles"
    label_suffix_strip = 5  # .webp

    def __init__(self, root: str, mode: str = "val"):
        super().__init__(root, mode)


class LostAndFound(OODDataset):
    """leftImg8bit/<mode>/** + gtCoarse labelTrainIds; labels 1→0, 2→1."""

    name = "lost_and_found"

    def __init__(self, root: str, mode: str = "test"):
        super().__init__()
        img_root = os.path.join(root, "leftImg8bit", mode)
        for dirpath, _, files in sorted(os.walk(img_root)):
            for f in sorted(files):
                if not f.endswith(".png"):
                    continue
                base = "_".join(f.split("_")[:-1])
                city = "_".join(f.split("_")[:-3])
                self.images.append(os.path.join(dirpath, base + "_leftImg8bit.png"))
                self.labels.append(
                    os.path.join(root, "gtCoarse", mode, city, base + "_gtCoarse_labelTrainIds.png")
                )

    def _remap(self, label):
        out = label.copy()
        out[label == 1] = 0
        out[label == 2] = 1
        return out.astype(np.int32)


# Cityscapes labelId → trainId (the standard 19-class mapping, as in the
# reference's datasets/cityscapes.py)
CITYSCAPES_ID_TO_TRAIN = np.full((256,), 255, np.int32)
for _tid, _ids in enumerate(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33]
):
    CITYSCAPES_ID_TO_TRAIN[_ids] = _tid

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)


class CityscapesSemSeg(OODDataset):
    """Cityscapes val split for mIoU (not anomaly): returns trainId labels.
    Prefers *_labelTrainIds.png; falls back to mapping *_labelIds.png."""

    name = "cityscapes"

    def __init__(self, root: str, split: str = "val"):
        super().__init__()
        img_root = os.path.join(root, "leftImg8bit", split)
        gt_root = os.path.join(root, "gtFine", split)
        self._from_train_ids = []
        for city in sorted(os.listdir(img_root)):
            for f in sorted(os.listdir(os.path.join(img_root, city))):
                base = f[: -len("_leftImg8bit.png")]
                self.images.append(os.path.join(img_root, city, f))
                tid = os.path.join(gt_root, city, base + "_gtFine_labelTrainIds.png")
                lid = os.path.join(gt_root, city, base + "_gtFine_labelIds.png")
                if os.path.exists(tid):
                    self.labels.append(tid)
                    self._from_train_ids.append(True)
                else:
                    self.labels.append(lid)
                    self._from_train_ids.append(False)

    def __getitem__(self, i: int) -> Sample:
        image = _read_image(self.images[i])
        label = _read_label(self.labels[i])
        if not self._from_train_ids[i]:
            label = CITYSCAPES_ID_TO_TRAIN[np.clip(label, 0, 255)]
        return Sample(image, label.astype(np.int32), os.path.basename(self.images[i]))


class BDD100KSeg(OODDataset):
    """BDD100K semantic segmentation (the reference's datasets/bdd100k.py): reads
    ``<split>_paths.txt`` files of "image,label" pairs rooted at the dataset
    dir (the reference's convention); falls back to the standard
    images/<split> + labels/<split>/*_train_id.png layout."""

    name = "bdd100k"

    def __init__(self, root: str, split: str = "val", resize_to=(720, 1280)):
        super().__init__()
        paths_file = os.path.join(root, f"{split}_paths.txt")
        if os.path.exists(paths_file):
            with open(paths_file) as f:
                for line in f:
                    line = line.strip()
                    if "," in line:
                        img, lab = line.split(",")[:2]
                        self.images.append(os.path.join(root, img))
                        self.labels.append(os.path.join(root, lab))
        else:
            img_root = os.path.join(root, "images", split)
            lab_root = os.path.join(root, "labels", split)
            if os.path.isdir(img_root):
                for f in sorted(os.listdir(img_root)):
                    base = os.path.splitext(f)[0]
                    self.images.append(os.path.join(img_root, f))
                    self.labels.append(os.path.join(lab_root, base + "_train_id.png"))
        self.resize_to = resize_to


class StreetHazards(OODDataset):
    """StreetHazards (the reference's ``datasets/street_hazards.py``): images/<split>/**
    and annotations/<split>/** PNGs; the anomaly class id 13 (14 on disk, where ids are
    1-based) → 1, everything else → 0."""

    name = "street_hazards"
    ANOMALY_ID = 13

    def __init__(self, root: str, split: str = "test"):
        super().__init__()
        img_root = os.path.join(root, "images", split)
        ann_root = os.path.join(root, "annotations", split)
        for dirpath, _, files in sorted(os.walk(img_root)):
            for f in sorted(files):
                if not f.endswith(".png"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, f), img_root)
                self.images.append(os.path.join(img_root, rel))
                self.labels.append(os.path.join(ann_root, rel))

    def _remap(self, label):
        return (label == self.ANOMALY_ID + 1).astype(np.int32)  # ids are 1-based


class SyntheticAnomaly(OODDataset):
    """Procedural dataset for tests/benches: inlier background with a bright
    square anomaly.  No file IO."""

    name = "synthetic"

    def __init__(self, n: int = 4, hw: Tuple[int, int] = (128, 192), seed: int = 0):
        super().__init__()
        self.n = n
        self.hw = hw
        self.seed = seed
        self.images = [str(i) for i in range(n)]
        self.labels = [str(i) for i in range(n)]

    def __getitem__(self, i: int) -> Sample:
        rng = np.random.RandomState(self.seed + i)
        h, w = self.hw
        img = (rng.rand(h, w, 3) * 80 + 60).astype(np.uint8)
        label = np.zeros((h, w), np.int32)
        y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
        sh, sw = h // 4, w // 4
        img[y : y + sh, x : x + sw] = 250
        label[y : y + sh, x : x + sw] = 1
        label[:2] = 255  # ignore strip
        return Sample(img, label, f"synthetic_{i}")


class SyntheticStructured(OODDataset):
    """Structured procedural scenes for numerics checks: uniform-noise images
    exercise none of the spatial structure real photographs have, so precision deltas measured on them do not
    bound real-data deltas.  Each image composites (seeded per index):

    - a vertical sky→ground luminance gradient,
    - low-frequency "terrain" noise (coarse noise bilinearly upsampled),
    - periodic texture bands (stripes / checker patches of varying pitch,
      road-marking-like),
    - 6–12 inlier objects (rectangles/ellipses with distinct albedo and
      soft edges),
    - 1–4 anomaly objects (ellipses/polygons with out-of-palette colors
      and contrasting texture) labeled 1,
    - a 2-px ignore strip at the top (mirrors SyntheticAnomaly).

    No file IO; deterministic per (seed, index).
    """

    name = "synthetic_structured"

    def __init__(self, n: int = 64, hw: Tuple[int, int] = (1024, 2048), seed: int = 0):
        super().__init__()
        self.n = n
        self.hw = hw
        self.seed = seed
        self.images = [str(i) for i in range(n)]
        self.labels = [str(i) for i in range(n)]

    @staticmethod
    def _upsample(coarse: np.ndarray, h: int, w: int) -> np.ndarray:
        """Bilinear upsample a (ch, cw) grid to (h, w) with numpy only."""
        ch, cw = coarse.shape
        yi = np.linspace(0, ch - 1, h)
        xi = np.linspace(0, cw - 1, w)
        y0 = np.clip(yi.astype(np.int64), 0, ch - 2)
        x0 = np.clip(xi.astype(np.int64), 0, cw - 2)
        ty = (yi - y0)[:, None]
        tx = (xi - x0)[None, :]
        c00 = coarse[y0][:, x0]
        c01 = coarse[y0][:, x0 + 1]
        c10 = coarse[y0 + 1][:, x0]
        c11 = coarse[y0 + 1][:, x0 + 1]
        return (c00 * (1 - ty) * (1 - tx) + c01 * (1 - ty) * tx
                + c10 * ty * (1 - tx) + c11 * ty * tx)

    def __getitem__(self, i: int) -> Sample:
        rng = np.random.RandomState(self.seed * 100003 + i)
        h, w = self.hw
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

        # sky→ground gradient + low-frequency terrain
        base = 90 + 70 * (1 - yy / h)
        terrain = self._upsample(rng.randn(8, 16) * 25, h, w)
        img = np.repeat((base + terrain)[..., None], 3, axis=-1)
        img += rng.randn(1, 1, 3) * 10  # global color cast

        # periodic texture bands (stripes of varying pitch/orientation)
        for _ in range(rng.randint(2, 5)):
            y0b, y1b = sorted(rng.randint(0, h, 2))
            pitch = rng.randint(8, 64)
            phase = (xx if rng.rand() < 0.5 else xx + yy)[y0b:y1b]
            stripe = (np.sin(2 * np.pi * phase / pitch) > 0).astype(np.float32)
            img[y0b:y1b] += stripe[..., None] * rng.uniform(8, 25)

        label = np.zeros((h, w), np.int32)

        def paint(cy, cx, ry, rx, color, anomaly, texture):
            if rng.rand() < 0.5:  # ellipse
                m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            else:  # rotated rectangle-ish (axis-aligned box)
                m = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
            tex = 1.0 + texture * np.sin(2 * np.pi * (xx + yy) / rng.randint(6, 24))
            img[m] = (color[None] * tex[m][:, None]).astype(np.float32)
            if anomaly:
                label[m] = 1

        # inlier objects: palette near the background statistics
        for _ in range(rng.randint(6, 13)):
            paint(rng.randint(0, h), rng.randint(0, w),
                  rng.randint(h // 32, h // 6), rng.randint(w // 32, w // 6),
                  rng.uniform(40, 200, 3), anomaly=False,
                  texture=rng.uniform(0, 0.15))
        # anomalies: saturated out-of-palette colors, contrasting texture
        for _ in range(rng.randint(1, 5)):
            c = np.zeros(3)
            c[rng.randint(3)] = rng.uniform(200, 255)
            paint(rng.randint(h // 8, h - h // 8), rng.randint(w // 8, w - w // 8),
                  rng.randint(h // 40, h // 10), rng.randint(w // 40, w // 10),
                  c, anomaly=True, texture=rng.uniform(0.2, 0.5))

        img += rng.randn(h, w, 3) * 3  # sensor noise
        label[:2] = 255  # ignore strip
        return Sample(np.clip(img, 0, 255).astype(np.uint8), label,
                      f"synthetic_structured_{i}")


def get_datasets(datasets_folder: str) -> dict:
    """Mirror of the reference's support.get_datasets: instantiate the
    standard evaluation suite rooted at ``datasets_folder``.  Missing dataset
    folders are skipped with a note so partial data directories still work."""
    specs = {
        "road_anomaly": lambda: RoadAnomaly(
            os.path.join(datasets_folder, "RoadAnomaly/RoadAnomaly_jpg")
        ),
        "fishyscapes_laf": lambda: FishyscapesLAF(os.path.join(datasets_folder, "Fishyscapes")),
        "fs_static": lambda: FishyscapesStatic(os.path.join(datasets_folder, "Fishyscapes"), 1),
        "fs_static_v2": lambda: FishyscapesStatic(os.path.join(datasets_folder, "Fishyscapes"), 2),
        "road_anomaly_21": lambda: RoadAnomaly21(
            os.path.join(datasets_folder, "SegmentMeIfYouCan/dataset_AnomalyTrack")
        ),
        "road_obstacles": lambda: RoadObstacle21(
            os.path.join(datasets_folder, "SegmentMeIfYouCan/dataset_ObstacleTrack")
        ),
        "lost_and_found": lambda: LostAndFound(os.path.join(datasets_folder, "LostAndFound")),
        "cityscapes": lambda: CityscapesSemSeg(os.path.join(datasets_folder, "cityscapes")),
        "bdd100k": lambda: BDD100KSeg(os.path.join(datasets_folder, "bdd100k/seg")),
    }
    out = {}
    for name, ctor in specs.items():
        try:
            ds = ctor()
        except (FileNotFoundError, OSError):
            continue
        if len(ds) > 0:  # os.walk-based readers yield empty sets when absent
            out[name] = ds
    return out


class SmallObstacles(OODDataset):
    """Small Obstacles (the reference's ``datasets/small_obstacles.py``):
    <root>/<mode>/<sequence>/{image,labels}/*.png with RGB colour labels: road
    (128, 0, 0) → 0, void (0, 0, 0) → 255, every other colour → anomaly 1."""

    name = "small_obstacles"

    def __init__(self, root: str, mode: str = "val"):
        super().__init__()
        base = os.path.join(root, mode)
        for seq in sorted(os.listdir(base)):
            labels_path = os.path.join(base, seq, "labels")
            images_path = os.path.join(base, seq, "image")
            for n in sorted(os.listdir(labels_path)):
                self.images.append(os.path.join(images_path, n))
                self.labels.append(os.path.join(labels_path, n))

    def __getitem__(self, i: int) -> Sample:
        image = _read_image(self.images[i])
        rgb = np.asarray(Image.open(self.labels[i]).convert("RGB"))
        r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
        label = np.ones(rgb.shape[:2], np.int32)
        label[(r == 0) & (g == 0) & (b == 0)] = 255
        label[(r == 128) & (g == 0) & (b == 0)] = 0
        return Sample(image, label, os.path.basename(self.images[i]))


class MapillarySemSeg(OODDataset):
    """Mapillary Vistas semantic segmentation (the reference's ``datasets/mapillary.py``):
    <root>/<training|validation>/{images/*.jpg, labels/*.png}.  With
    ``cityscapes_taxonomy`` the 66 Mapillary ids map to the 19 Cityscapes train ids
    (``taxonomies.mapillary_to_cityscapes_lut``, 255 elsewhere), the labels the
    Mapillary fine-tuned checkpoints train and evaluate on; else the raw ids."""

    name = "mapillary"

    def __init__(self, root: str, mode: str = "val", cityscapes_taxonomy: bool = True):
        super().__init__()
        folder = {"train": "training", "val": "validation"}[mode]
        images_path = os.path.join(root, folder, "images")
        labels_path = os.path.join(root, folder, "labels")
        for img in sorted(os.listdir(images_path)):
            self.images.append(os.path.join(images_path, img))
            self.labels.append(os.path.join(labels_path, img[:-3] + "png"))
        self._lut = None
        if cityscapes_taxonomy:
            from .taxonomies import mapillary_to_cityscapes_lut

            self._lut = mapillary_to_cityscapes_lut()

    def _remap(self, label):
        if self._lut is None:
            return label
        return self._lut[np.clip(label, 0, 255)]


class CityscapesC(CityscapesSemSeg):
    """Corrupted Cityscapes (the reference's ``datasets/cityscapes_c.py``): images under
    leftImg8bit/<split>/<city>/<distortion>/<severity>/, labels the clean gtFine maps."""

    name = "cityscapes_c"

    def __init__(self, root: str, split: str = "val", distortion: str = "gaussian_noise", severity: str = "1"):
        OODDataset.__init__(self)
        img_root = os.path.join(root, "leftImg8bit", split)
        gt_root = os.path.join(root, "gtFine", split)
        self._from_train_ids = []
        for city in sorted(os.listdir(img_root)):
            img_dir = os.path.join(img_root, city, distortion, str(severity))
            if not os.path.isdir(img_dir):
                continue
            for f in sorted(os.listdir(img_dir)):
                base = f[: -len("_leftImg8bit.png")]
                self.images.append(os.path.join(img_dir, f))
                tid = os.path.join(gt_root, city, base + "_gtFine_labelTrainIds.png")
                lid = os.path.join(gt_root, city, base + "_gtFine_labelIds.png")
                use_tid = os.path.exists(tid)
                self.labels.append(tid if use_tid else lid)
                self._from_train_ids.append(use_tid)


class CityscapesIncremental(CityscapesSemSeg):
    """Incremental-class Cityscapes (the reference's ``datasets/cityscapes_incremental.py``):
    the train ids in ``holdout_classes`` become anomaly 1, every other id inlier 0, and
    255 stays: OOD detection evaluated on held-out known classes."""

    name = "cityscapes_incremental"

    def __init__(self, root: str, split: str = "val", holdout_classes=(13, 14, 15)):
        super().__init__(root, split)
        self.holdout = set(int(c) for c in holdout_classes)

    def __getitem__(self, i: int) -> Sample:
        s = super().__getitem__(i)
        label = np.zeros_like(s.label)
        label[s.label == 255] = 255
        for c in self.holdout:
            label[s.label == c] = 1
        return Sample(s.image, label, s.name)


# ---------------------------------------------------------------------------
# Panoptic ground truth and its instance and semantic views
# ---------------------------------------------------------------------------

def rgb2id(color: np.ndarray) -> np.ndarray:
    """COCO panoptic encoding of an (H, W, 3) RGB id map: id = R + 256·G + 256²·B."""
    color = color.astype(np.int64)
    return color[:, :, 0] + 256 * color[:, :, 1] + 256 * 256 * color[:, :, 2]


class PanopticDataset:
    """COCO-format panoptic ground truth: a JSON of annotations plus RGB id-map PNGs.
    Yields (image, pan_id_map, segments_info) tuples.  ``category_map`` converts each
    segment's raw dataset category id to its contiguous training id (and marks
    ``isthing`` from ``thing_dataset_ids``, the raw ids of the thing classes), as the
    reference does when it registers a panoptic dataset."""

    name = "panoptic"

    def __init__(self, image_root: str, panoptic_root: str, json_path: str,
                 category_map=None, thing_dataset_ids=None):
        self.category_map = dict(category_map) if category_map else None
        self.thing_dataset_ids = set(int(i) for i in thing_dataset_ids) if thing_dataset_ids else set()
        with open(json_path) as f:
            meta = json.load(f)
        images = {im["id"]: im["file_name"] for im in meta.get("images", [])}
        self.entries = []
        for ann in meta["annotations"]:
            img_name = images.get(ann.get("image_id"), ann["file_name"].replace(".png", ".jpg"))
            self.entries.append((os.path.join(image_root, img_name), os.path.join(panoptic_root, ann["file_name"]),
                                 ann["segments_info"]))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        img_path, pan_path, segments = self.entries[i]
        image = _read_image(img_path)
        pan = rgb2id(np.asarray(Image.open(pan_path).convert("RGB")))
        if self.category_map is not None:
            segments = [{**s, "category_id": self.category_map[int(s["category_id"])],
                         "isthing": int(s["category_id"]) in self.thing_dataset_ids} for s in segments]
        return image, pan, segments

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class InstanceFromPanoptic:
    """Instance view of panoptic ground truth: each non-crowd segment of a thing class
    (``thing_ids``, contiguous; all classes when None) becomes one binary mask and
    class.  Yields (image, masks (N, H, W) uint8, classes (N,) int32)."""

    name = "instance_from_panoptic"

    def __init__(self, panoptic: PanopticDataset, thing_ids=None):
        self.panoptic = panoptic
        self.thing_ids = set(int(c) for c in thing_ids) if thing_ids is not None else None

    def __len__(self):
        return len(self.panoptic)

    def __getitem__(self, i):
        image, pan, segments = self.panoptic[i]
        masks, classes = [], []
        for seg in segments:
            if seg.get("iscrowd", 0):
                continue
            cls = int(seg["category_id"])
            if cls == 255:  # the unknown sentinel is never a class
                continue
            if self.thing_ids is not None and cls not in self.thing_ids:
                continue
            m = (pan == seg["id"]).astype(np.uint8)
            if m.any():
                masks.append(m)
                classes.append(cls)
        h, w = pan.shape
        masks = np.stack(masks) if masks else np.zeros((0, h, w), np.uint8)
        return image, masks, np.asarray(classes, np.int32)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class SemSegFromPanoptic(OODDataset):
    """Semantic view of panoptic ground truth: label[pan == id] = category_id, 255
    elsewhere (the map the reference prepares offline and scores for mIoU when
    ``SEMANTIC_ON``)."""

    name = "sem_seg_from_panoptic"

    def __init__(self, panoptic: PanopticDataset):
        super().__init__()
        self.panoptic = panoptic

    def __len__(self):
        return len(self.panoptic)

    def __getitem__(self, i: int) -> Sample:
        image, pan, segments = self.panoptic[i]
        label = np.full(pan.shape, 255, np.int32)
        for seg in segments:
            label[pan == seg["id"]] = int(seg["category_id"])
        return Sample(image, label, str(i))


class SemSegFolder(OODDataset):
    """An (image directory, label directory) pair matched by file stem, Detectron2's
    ``load_sem_seg`` as the reference registers the Mapillary, COCO-Stuff-10k and
    StreetHazards splits with it (labels ``*.png``; any image extension).  The labels are
    the dataset's raw train ids, not binary OOD labels.  A missing directory gives an
    empty reader."""

    name = "sem_seg_folder"

    def __init__(self, image_root: str, sem_seg_root: str):
        super().__init__()
        self.image_root = image_root
        self.sem_seg_root = sem_seg_root
        if not os.path.isdir(image_root):
            return
        labels = {}
        for f in os.listdir(sem_seg_root) if os.path.isdir(sem_seg_root) else []:
            if f.endswith(".png"):
                labels[os.path.splitext(f)[0]] = os.path.join(sem_seg_root, f)
        for f in sorted(os.listdir(image_root)):
            stem = os.path.splitext(f)[0]
            if stem in labels:
                self.images.append(os.path.join(image_root, f))
                self.labels.append(labels[stem])
