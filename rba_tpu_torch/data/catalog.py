"""Dataset catalog: datasets registered and looked up by name (counterpart of
``rba_tpu/data/catalog.py``).

The reference resolves names such as ``cityscapes_fine_sem_seg_val`` or
``coco_2017_val_panoptic_open`` (a config's ``DATASETS.TEST``) through Detectron2's
DatasetCatalog and MetadataCatalog; here a name maps to a callable that builds the
reader, and to its metadata.  ``register_standard_datasets(root)`` registers the
reference's names under a datasets directory (Detectron2's ``DETECTRON2_DATASETS``):
Cityscapes, Mapillary Vistas (its 65 classes, the Cityscapes taxonomy and panoptic),
COCO panoptic (closed and open), COCO-Stuff-10k, StreetHazards and the OOD evaluation
sets.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable[[], object]] = {}
_METADATA: Dict[str, Dict] = {}
_STANDARD_ROOT = None
_STANDARD_OWNED: set = set()


def register(name: str, factory: Callable[[], object], **metadata) -> None:
    if name in _REGISTRY:
        raise KeyError(f"dataset {name!r} already registered")
    _REGISTRY[name] = factory
    _METADATA[name] = metadata


def get(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"dataset {name!r} not registered; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def metadata(name: str) -> Dict:
    return _METADATA.get(name, {})


def registered() -> list:
    return sorted(_REGISTRY)


def coco_panoptic_metadata(open_panoptic: bool = False) -> Dict:
    """COCO's 133-class panoptic metadata: thing and stuff classes and colours, and the
    raw-id → contiguous-id maps.  The open variant holds out the 16 unknown thing
    classes: they map to 255, and the kept classes take a running contiguous index."""
    from .categories import COCO_PANOPTIC_CATEGORIES, OPEN_PANOPTIC_UNKNOWN_CLASSES

    unknown = set(OPEN_PANOPTIC_UNKNOWN_CLASSES) if open_panoptic else set()
    cats = COCO_PANOPTIC_CATEGORIES
    thing = [(n, c) for _, isth, n, c in cats if isth == 1 and n not in unknown]
    if open_panoptic:
        thing_map, stuff_map = {}, {}
        index = 0
        for i, isth, n, _ in cats:
            if isth == 1 and n in unknown:
                thing_map[i] = 255
            elif isth == 1:
                thing_map[i] = index
                index += 1
            else:
                stuff_map[i] = index
                index += 1
    else:  # positions in the full list, for both maps
        thing_map = {i: idx for idx, (i, isth, _, _) in enumerate(cats) if isth == 1}
        stuff_map = {i: idx for idx, (i, _, _, _) in enumerate(cats)}
    meta = {
        "thing_classes": [n for n, _ in thing],
        "thing_colors": [list(c) for _, c in thing],
        "stuff_classes": [n for _, _, n, _ in cats],
        "stuff_colors": [list(c) for _, _, _, c in cats],
        "thing_dataset_id_to_contiguous_id": thing_map,
        "stuff_dataset_id_to_contiguous_id": stuff_map,
        "ignore_label": 255,
        "label_divisor": 1000,
    }
    if open_panoptic:
        meta["unknown_classes"] = list(OPEN_PANOPTIC_UNKNOWN_CLASSES)
    return meta


def coco_stuff_10k_metadata() -> Dict:
    """COCO-Stuff-10k's 171 classes, raw id → table position, ignore 255."""
    from .categories import COCO_STUFF_10K_CATEGORIES

    return {
        "stuff_classes": [n for _, _, n, _ in COCO_STUFF_10K_CATEGORIES],
        "stuff_dataset_id_to_contiguous_id": {i: idx for idx, (i, _, _, _) in enumerate(COCO_STUFF_10K_CATEGORIES)},
        "ignore_label": 255,
        "evaluator_type": "sem_seg",
    }


def mapillary_metadata() -> Dict:
    """Mapillary Vistas' 65 evaluated classes; the train id is the table position, and
    position 65 (void--unlabeled, not evaluated) is the ignore label."""
    from .categories import MAPILLARY_VISTAS_CATEGORIES

    evaluated = [(r, c) for _, r, _, ev, c in MAPILLARY_VISTAS_CATEGORIES if ev]
    return {
        "stuff_classes": [r for r, _ in evaluated],
        "stuff_colors": [list(c) for _, c in evaluated],
        "ignore_label": 65,
        "evaluator_type": "sem_seg",
    }


def mapillary_panoptic_metadata() -> Dict:
    """Mapillary Vistas panoptic: thing and stuff classes, raw id → table position."""
    from .categories import MAPILLARY_VISTAS_PANOPTIC_CATEGORIES

    cats = MAPILLARY_VISTAS_PANOPTIC_CATEGORIES
    return {
        "thing_classes": [n for _, isth, n, _ in cats if isth],
        "thing_colors": [list(c) for _, isth, _, c in cats if isth],
        "stuff_classes": [n for _, _, n, _ in cats],
        "stuff_colors": [list(c) for _, _, _, c in cats],
        "thing_dataset_id_to_contiguous_id": {i: idx for idx, (i, isth, _, _) in enumerate(cats) if isth},
        "stuff_dataset_id_to_contiguous_id": {i: idx for idx, (i, _, _, _) in enumerate(cats)},
        "ignore_label": 65,
        "label_divisor": 1000,
        "evaluator_type": "coco_panoptic_seg",
    }


def street_hazards_metadata() -> Dict:
    """StreetHazards' 14 names as thing and stuff classes, ignore label 12 (the class
    that the training mappers' taxonomy shift moves to the end)."""
    from .categories import STREET_HAZARDS_CLASSES

    return {
        "thing_classes": list(STREET_HAZARDS_CLASSES),
        "stuff_classes": list(STREET_HAZARDS_CLASSES),
        "ignore_label": 12,
        "evaluator_type": "sem_seg",
    }


def register_standard_datasets(root: str) -> None:
    """Register the reference's dataset names under the datasets directory ``root``.
    Called again with another ``root``, it re-points the names it registered itself;
    a name registered with ``register`` is never replaced."""
    from .ood_datasets import (
        BDD100KSeg,
        CityscapesSemSeg,
        FishyscapesLAF,
        FishyscapesStatic,
        LostAndFound,
        MapillarySemSeg,
        PanopticDataset,
        RoadAnomaly,
        RoadAnomaly21,
        RoadObstacle21,
        SemSegFolder,
        StreetHazards,
    )
    from .taxonomies import CITYSCAPES_CLASSES, CITYSCAPES_THING_CLASSES

    cs_meta = dict(stuff_classes=list(CITYSCAPES_CLASSES), thing_classes=list(CITYSCAPES_THING_CLASSES),
                   ignore_label=255, evaluator_type="cityscapes_sem_seg")
    cs = os.path.join(root, "cityscapes")
    coco = os.path.join(root, "coco")
    mapi = os.path.join(root, "mapillary_vistas")

    def cs_split(split):
        return lambda: CityscapesSemSeg(cs, split)

    def folder(images, labels):
        return lambda: SemSegFolder(os.path.join(root, images), os.path.join(root, labels))

    def panoptic_reader(image_root, pan_root, json_path, meta):
        # raw category ids → contiguous ids at registration; the thing map wins on overlap
        cmap = {**meta["stuff_dataset_id_to_contiguous_id"], **meta["thing_dataset_id_to_contiguous_id"]}
        things = set(meta["thing_dataset_id_to_contiguous_id"])
        return lambda: PanopticDataset(image_root, pan_root, json_path, category_map=cmap, thing_dataset_ids=things)

    def coco_panoptic(split, meta):
        return panoptic_reader(os.path.join(coco, f"{split}2017"), os.path.join(coco, f"panoptic_{split}2017"),
                               os.path.join(coco, f"annotations/panoptic_{split}2017.json"), meta)

    def mapillary_panoptic(folder_name, meta):
        return panoptic_reader(os.path.join(mapi, folder_name, "images"), os.path.join(mapi, folder_name, "panoptic"),
                               os.path.join(mapi, folder_name, "panoptic", "panoptic_2018.json"), meta)

    pan_meta = {**coco_panoptic_metadata(), "evaluator_type": "coco_panoptic_seg"}
    open_meta = {**coco_panoptic_metadata(open_panoptic=True), "evaluator_type": "coco_panoptic_seg"}
    instance_meta = {**cs_meta, "evaluator_type": "cityscapes_instance"}
    mapi_meta, mapi_pan_meta = mapillary_metadata(), mapillary_panoptic_metadata()
    stuff_meta, sh_meta = coco_stuff_10k_metadata(), street_hazards_metadata()
    specs = {
        "cityscapes_fine_sem_seg_train": (cs_split("train"), cs_meta),
        "cityscapes_fine_sem_seg_val": (cs_split("val"), cs_meta),
        "cityscapes_fine_sem_seg_test": (cs_split("test"), cs_meta),
        "cityscapes_coco_sem_seg_mix": (cs_split("train"), cs_meta),
        "cityscapes_fine_instance_seg_train": (cs_split("train"), instance_meta),
        "cityscapes_fine_instance_seg_val": (cs_split("val"), instance_meta),
        "mapillary_vistas_sem_seg_train": (folder("mapillary_vistas/training/images",
                                                  "mapillary_vistas/training/labels"), mapi_meta),
        "mapillary_vistas_sem_seg_val": (folder("mapillary_vistas/validation/images",
                                                "mapillary_vistas/validation/labels"), mapi_meta),
        "mapillary_vistas_panoptic_train": (mapillary_panoptic("training", mapi_pan_meta), mapi_pan_meta),
        "mapillary_vistas_panoptic_val": (mapillary_panoptic("validation", mapi_pan_meta), mapi_pan_meta),
        "mapillary_cityscapes_sem_seg_train": (lambda: MapillarySemSeg(mapi, "train"), cs_meta),
        "mapillary_cityscapes_sem_seg_val": (lambda: MapillarySemSeg(mapi, "val"), cs_meta),
        "coco_2017_train_panoptic": (coco_panoptic("train", pan_meta), pan_meta),
        "coco_2017_val_panoptic": (coco_panoptic("val", pan_meta), pan_meta),
        "coco_2017_train_panoptic_with_sem_seg": (coco_panoptic("train", pan_meta), pan_meta),
        "coco_2017_val_panoptic_with_sem_seg": (coco_panoptic("val", pan_meta), pan_meta),
        "coco_2017_train_panoptic_open": (coco_panoptic("train", open_meta), open_meta),
        "coco_2017_val_panoptic_open": (coco_panoptic("val", open_meta), open_meta),
        "coco_2017_train_stuff_10k_sem_seg": (folder("coco/coco_stuff_10k/images_detectron2/train",
                                                     "coco/coco_stuff_10k/annotations_detectron2/train"), stuff_meta),
        "coco_2017_test_stuff_10k_sem_seg": (folder("coco/coco_stuff_10k/images_detectron2/test",
                                                    "coco/coco_stuff_10k/annotations_detectron2/test"), stuff_meta),
        # the reference reads both StreetHazards splits from train/, and the OOD test set
        # from a second root, street_hazards/
        "street_hazards_sem_seg_train": (folder("StreetHazards/train/images", "StreetHazards/train/annotations"),
                                         sh_meta),
        "street_hazards_sem_seg_val": (folder("StreetHazards/train/images", "StreetHazards/train/annotations"),
                                       sh_meta),
        "street_hazards_test": (lambda: StreetHazards(os.path.join(root, "street_hazards")), {}),
        "road_anomaly": (lambda: RoadAnomaly(os.path.join(root, "RoadAnomaly/RoadAnomaly_jpg")), {}),
        "fishyscapes_laf": (lambda: FishyscapesLAF(os.path.join(root, "Fishyscapes")), {}),
        "fs_static": (lambda: FishyscapesStatic(os.path.join(root, "Fishyscapes"), 1), {}),
        "road_anomaly_21": (lambda: RoadAnomaly21(os.path.join(root, "SegmentMeIfYouCan/dataset_AnomalyTrack")), {}),
        "road_obstacles": (lambda: RoadObstacle21(os.path.join(root, "SegmentMeIfYouCan/dataset_ObstacleTrack")), {}),
        "lost_and_found": (lambda: LostAndFound(os.path.join(root, "LostAndFound")), {}),
        "bdd100k_sem_seg_val": (lambda: BDD100KSeg(os.path.join(root, "bdd100k/seg")), {}),
    }
    global _STANDARD_ROOT
    refresh = _STANDARD_ROOT is not None and _STANDARD_ROOT != root
    _STANDARD_ROOT = root
    for name, (factory, meta) in specs.items():
        if name not in _REGISTRY:
            _STANDARD_OWNED.add(name)
        elif not (refresh and name in _STANDARD_OWNED):
            continue
        _REGISTRY[name] = factory
        _METADATA[name] = meta
