"""The port's dataset readers against rba_tpu's on the same files: the same dataset
names, and equal images, labels and sample names (exact; the readers are numpy and
PIL on both sides)."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from rba_tpu.data import ood_datasets as jds
from rba_tpu.tools.selfcheck import build_synthetic_dataset_trees
from rba_tpu_torch.data import ood_datasets as tds


def _equal_datasets(got, want):
    assert len(got) == len(want) > 0
    assert got.name == want.name
    for g, w in zip(got, want):
        assert g.name == w.name
        assert g.image.dtype == np.uint8 and g.label.dtype == np.int32
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.label, w.label)


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _write_more_trees(root, rng, hw=(24, 40)):
    """Small trees in the layouts of the readers the selfcheck trees do not cover:
    LostAndFound, Cityscapes (labelIds only, so the id→trainId table is read),
    Fishyscapes Static v1 and BDD100K (a paths file)."""
    def image():
        return rng.randint(0, 256, (*hw, 3)).astype(np.uint8)

    for i in range(2):
        base = f"04_Maurener_Weg_8_{i:06d}_000030"
        _png(os.path.join(root, "LostAndFound", "leftImg8bit", "test", "04_Maurener_Weg_8",
                          base + "_leftImg8bit.png"), image())
        _png(os.path.join(root, "LostAndFound", "gtCoarse", "test", "04_Maurener_Weg_8",
                          base + "_gtCoarse_labelTrainIds.png"), rng.choice([0, 1, 2, 255], hw).astype(np.uint8))
        base = f"frankfurt_{i:06d}_000294"
        _png(os.path.join(root, "cityscapes", "leftImg8bit", "val", "frankfurt", base + "_leftImg8bit.png"), image())
        _png(os.path.join(root, "cityscapes", "gtFine", "val", "frankfurt", base + "_gtFine_labelIds.png"),
             rng.randint(0, 34, hw).astype(np.uint8))
        _png(os.path.join(root, "Fishyscapes", "fs_val_v1", f"{i:04d}_labels.png"),
             rng.choice([0, 1, 255], hw).astype(np.uint8))
        _png(os.path.join(root, "Fishyscapes", "fs_static_images_v1", f"{i:04d}_rgb.png"), image())
        _png(os.path.join(root, "bdd100k", "seg", "images", "val", f"b{i}.jpg"), image())
        _png(os.path.join(root, "bdd100k", "seg", "labels", "val", f"b{i}_train_id.png"),
             rng.randint(0, 19, hw).astype(np.uint8))
    with open(os.path.join(root, "bdd100k", "seg", "val_paths.txt"), "w") as f:
        f.write("\n".join(f"images/val/b{i}.jpg,labels/val/b{i}_train_id.png" for i in range(2)))
    return ["bdd100k", "cityscapes", "fs_static", "lost_and_found"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    names = build_synthetic_dataset_trees(root, hw=(32, 48), n=2)
    names += _write_more_trees(root, np.random.RandomState(3))
    return root, sorted(names)


def test_get_datasets_finds_the_same_names(trees):
    root, names = trees
    assert sorted(tds.get_datasets(root)) == sorted(jds.get_datasets(root)) == names
    assert tds.get_datasets(os.path.join(root, "absent")) == {}


@pytest.mark.parametrize("name", ["bdd100k", "cityscapes", "fishyscapes_laf", "fs_static", "lost_and_found",
                                  "road_anomaly", "road_anomaly_21"])
def test_readers_yield_equal_samples(trees, name):
    root, _ = trees
    got, want = tds.get_datasets(root)[name], jds.get_datasets(root)[name]
    _equal_datasets(got, want)
    labels = np.concatenate([s.label.ravel() for s in got])
    if name == "cityscapes":  # trainIds through the id→trainId table
        assert set(np.unique(labels)) <= set(range(19)) | {255}
        np.testing.assert_array_equal(tds.CITYSCAPES_ID_TO_TRAIN, jds.CITYSCAPES_ID_TO_TRAIN)
    elif name not in ("bdd100k",):
        assert set(np.unique(labels)) <= {0, 1, 255}
    if name == "road_anomaly_21":
        assert got[0].image.shape == (720, 1280, 3)


def test_smiyc_test_mode_and_obstacle_track(tmp_path, rng):
    """SMIYC test-mode files (no labels) and the ObstacleTrack reader, on one tree."""
    root = tmp_path / "dataset_ObstacleTrack"
    for f in ("validation_0001.webp", "test_0001.webp"):
        _png(str(root / "images" / f), rng.randint(0, 256, (16, 24, 3)).astype(np.uint8))
    _png(str(root / "labels_masks" / "validation_0001_labels_semantic.png"),
         rng.choice([0, 1, 255], (16, 24)).astype(np.uint8))
    for mode in ("val", "test", "all"):
        _equal_datasets(tds.RoadObstacle21(str(root), mode), jds.RoadObstacle21(str(root), mode))


@pytest.mark.parametrize("cls, kw", [
    ("SyntheticAnomaly", dict(n=3, hw=(40, 56), seed=1)),
    ("SyntheticStructured", dict(n=2, hw=(64, 96), seed=0)),
])
def test_synthetic_datasets_equal(cls, kw):
    _equal_datasets(getattr(tds, cls)(**kw), getattr(jds, cls)(**kw))


def test_fs_static_version_must_be_1_or_2(tmp_path):
    with pytest.raises(ValueError, match="versions"):
        tds.FishyscapesStatic(str(tmp_path), version=3)


def test_road_anomaly_frame_list(trees):
    root, _ = trees
    with open(os.path.join(root, "RoadAnomaly", "RoadAnomaly_jpg", "frame_list.json")) as f:
        frames = json.load(f)
    ds = tds.RoadAnomaly(os.path.join(root, "RoadAnomaly", "RoadAnomaly_jpg"))
    assert [os.path.basename(p) for p in ds.images] == frames
