"""Dataset taxonomies and label mappings (counterpart of ``rba_tpu/data/taxonomies.py``).

- ``MAPILLARY_TO_CITYSCAPES_IDS``: the 66 Mapillary Vistas v1.2 classes, in train-id
  order, mapped to the 19 Cityscapes train ids (255: void), the table of the reference's
  Mapillary-with-Cityscapes-taxonomy registration, which the Mapillary fine-tuned
  checkpoints (``swin_*_1dl_rba_ood_map_coco``) train on;
- the Cityscapes class names, palette and thing classes;
- the 13-class StreetHazards taxonomy and its anomaly id 13 (14 on disk, 1-based).

The LUTs are numpy arrays: ``mapped = LUT[labels]``.
"""
from __future__ import annotations

import numpy as np

# Mapillary Vistas v1.2 category order (66) → Cityscapes trainIds, extracted
# from MAPPILARY_TO_CITYSCAPES (reference :472-560); 255 = void.
MAPILLARY_TO_CITYSCAPES_IDS = np.asarray(
    [
        255, 255, 1, 4, 255, 255, 3, 255, 255, 255, 255, 255, 255, 0, 255, 1,
        255, 2, 255, 11, 12, 12, 12, 0, 0, 255, 255, 10, 255, 9, 8, 255, 255,
        255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 5, 255, 5,
        6, 255, 7, 255, 18, 255, 15, 13, 255, 17, 16, 255, 255, 14, 255, 255,
        255, 255,
    ],
    dtype=np.int32,
)


def mapillary_to_cityscapes_lut(size: int = 256) -> np.ndarray:
    """LUT over the full uint8 label range: ids ≥ 66 (incl. the Mapillary
    ignore id 65 ∈ table) map to 255."""
    lut = np.full((size,), 255, np.int32)
    lut[: len(MAPILLARY_TO_CITYSCAPES_IDS)] = MAPILLARY_TO_CITYSCAPES_IDS
    return lut


CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)

CITYSCAPES_PALETTE = np.asarray(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)

CITYSCAPES_THING_CLASSES = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)

STREET_HAZARDS_CLASSES = (
    "background", "road", "street", "traffic light", "traffic sign",
    "vegetation", "terrain", "sky", "person", "car", "truck", "bus", "wall",
)
STREET_HAZARDS_ANOMALY_ID = 13
