"""The port's panoptic, instance, LSJ, void and StreetHazards training mappers against
rba_tpu's on synthetic arrays: the same seed and input in both packages, every output
array equal bit for bit (numpy, PIL and ``random.Random`` on both sides), the
unseen-class filter included; and the helpers ``lsj_augment``, ``rgb2id``,
``load_unseen_label_set``, ``cityscapes_void_lut`` and ``street_hazards_shift``."""
import numpy as np
import pytest

from rba_tpu.data import mappers as jm
from rba_tpu_torch.data import mappers as tm
from tests.test_torch_mappers import GEOMETRY, _assert_same, _objects, _scenes

# (segment id, class, crowd) of each panoptic scene: 255 is the ignore class (an unknown
# thing of the open protocol), class 5 is held out as unseen, one crowd segment
SEGMENTS = [(1001, 0, 0), (2500, 3, 0), (70000, 5, 0), (3, 255, 0), (4242, 2, 1), (9, 6, 0)]


def _panoptic_scenes(n, seed=0, hw=(64, 128)):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rs.randint(0, 256, (*hw, 3)).astype(np.uint8)
        ids = np.zeros(hw, np.int32)  # 0: unlabelled
        for sid, _, _ in SEGMENTS:
            y, x = rs.randint(0, hw[0] - 16), rs.randint(0, hw[1] - 24)
            ids[y : y + rs.randint(8, 24), x : x + rs.randint(8, 40)] = sid
        segments = [{"id": sid, "category_id": c, "iscrowd": crowd} for sid, c, crowd in SEGMENTS]
        out.append((img, ids, segments))
    return out


def _instance_scenes(n, seed=0, hw=(64, 128)):
    return [(img, np.stack([ids == sid for sid, _, _ in SEGMENTS[:4]]).astype(np.uint8),
             np.array([c % 7 for _, c, _ in SEGMENTS[:4]], np.int32))
            for img, ids, _ in _panoptic_scenes(n, seed, hw)]


def test_rgb2id():
    rs = np.random.RandomState(0)
    rgb = rs.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    got = tm.rgb2id(rgb)
    assert got.dtype == np.int64 and np.array_equal(got, jm.rgb2id(rgb))
    assert got[0, 0] == int(rgb[0, 0, 0]) + 256 * int(rgb[0, 0, 1]) + 65536 * int(rgb[0, 0, 2])


@pytest.mark.parametrize("color_aug", [True, False])
@pytest.mark.parametrize("unseen", [None, (5,)])
def test_panoptic_mapper_bit_exact(color_aug, unseen):
    kw = dict(seed=3, unseen_label_set=unseen)
    jmap = jm.PanopticDatasetMapper(jm.MapperConfig(color_aug=color_aug, **GEOMETRY), **kw)
    tmap = tm.PanopticDatasetMapper(tm.MapperConfig(color_aug=color_aug, **GEOMETRY), **kw)
    labels = []
    for img, ids, segs in _panoptic_scenes(5):
        want = jmap(img, ids, segs)
        _assert_same(tmap(img, ids, segs), want)
        labels += list(want["gt_labels"][want["gt_valid"] > 0])
    assert 255 not in labels and 2 not in labels  # the ignore class and the crowd segment
    assert (5 in labels) == (unseen is None)  # class 5's segment id, 70000, needs more than 16 bits


def test_instance_mapper_bit_exact():
    jmap = jm.InstanceDatasetMapper(jm.MapperConfig(**GEOMETRY), seed=5)
    tmap = tm.InstanceDatasetMapper(tm.MapperConfig(**GEOMETRY), seed=5)
    for img, masks, classes in _instance_scenes(5, seed=1):
        _assert_same(tmap(img, masks, classes), jmap(img, masks, classes))
    empty = (np.zeros((64, 128, 3), np.uint8), np.zeros((0, 64, 128), np.uint8), np.zeros((0,), np.int32))
    _assert_same(tmap(*empty), jmap(*empty))


@pytest.mark.parametrize("flip", [True, False])
def test_panoptic_lsj_mapper_bit_exact(flip):
    """Scales of 0.1-2.0 of a 96x96 canvas: each frame is cropped (scale > 0.75) or padded,
    image with 128 and ids with 0, which is no segment."""
    cfg = dict(GEOMETRY, flip=flip)
    jmap = jm.PanopticLSJDatasetMapper(jm.MapperConfig(**cfg), seed=2, image_size=96, unseen_label_set=(5,))
    tmap = tm.PanopticLSJDatasetMapper(tm.MapperConfig(**cfg), seed=2, image_size=96, unseen_label_set=(5,))
    padded = 0
    for img, ids, segs in _panoptic_scenes(8, seed=4):
        want = jmap(img, ids, segs)
        _assert_same(tmap(img, ids, segs), want)
        assert want["images"].shape == (96, 96, 3) and want["gt_masks"].shape == (6, 96, 96)
        labels = want["gt_labels"][want["gt_valid"] > 0]
        assert not set(labels) & {5, 255, 2}
        padded += int((want["images"][-1, -1] == 128).all())
    assert padded > 0


def test_instance_lsj_mapper_bit_exact():
    jmap = jm.InstanceLSJDatasetMapper(jm.MapperConfig(**GEOMETRY), seed=9, image_size=80, min_scale=0.5)
    tmap = tm.InstanceLSJDatasetMapper(tm.MapperConfig(**GEOMETRY), seed=9, image_size=80, min_scale=0.5)
    for img, masks, classes in _instance_scenes(6, seed=2):
        _assert_same(tmap(img, masks, classes), jmap(img, masks, classes))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lsj_augment_bit_exact(seed):
    """Pads the image with 128 and the labels with ``ignore_label``."""
    import random

    img, sem = _scenes(1, seed=seed)[0]
    for ignore in (255, 65):
        got = tm.lsj_augment(random.Random(seed), img, sem, image_size=100, ignore_label=ignore)
        want = jm.lsj_augment(random.Random(seed), img, sem, image_size=100, ignore_label=ignore)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    small = tm.lsj_augment(random.Random(0), img, sem, image_size=400, min_scale=0.1, max_scale=0.2,
                           ignore_label=65)
    assert (small[0][-1] == 128).all() and (small[1][-1] == 65).all()


def test_load_unseen_label_set(tmp_path, capsys):
    path = tmp_path / "unknown.txt"
    path.write_text("car\n\n3\nno such class\nbus\n-1\n")
    names = ["person", "bus", "truck", "car"]
    assert tm.load_unseen_label_set(str(path), names) == jm.load_unseen_label_set(str(path), names) == [3, 3, 1, -1]
    assert capsys.readouterr().out.count("no such class") == 2  # each package warns once


def test_cityscapes_void_lut():
    got, want = tm.cityscapes_void_lut(), jm.cityscapes_void_lut()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got[7] == 0 and got[33] == 18 and got[4] == 254 and got[0] == 255


def test_street_hazards_shift():
    labels = np.arange(0, 16, dtype=np.uint8).reshape(1, 16)
    got = tm.street_hazards_shift(labels)
    assert got.dtype == np.int32 and np.array_equal(got, jm.street_hazards_shift(labels))
    assert got[0, 4] == 12 and got[0, 5] == 3  # class 3 (1-based 4) moves to the end, the rest close up


def _void_scenes(n, seed=0):
    """Cityscapes labelIds: classes, ambiguous void (254 after the LUT) and true void."""
    rs = np.random.RandomState(seed)
    ids = np.array([7, 8, 11, 26, 4, 5, 0, 1, 24], np.uint8)
    return [(img, ids[np.repeat(np.repeat(rs.randint(0, len(ids), (8, 16)), 8, 0), 8, 1)])
            for img, _ in _scenes(n, seed)]


def test_void_mapper_bit_exact():
    jmap = jm.SemanticVoidDatasetMapper(jm.MapperConfig(**GEOMETRY), seed=1)
    tmap = tm.SemanticVoidDatasetMapper(tm.MapperConfig(**GEOMETRY), seed=1)
    outliers = 0
    for img, lab in _void_scenes(5):
        want = jmap(img, lab)
        _assert_same(tmap(img, lab), want)
        assert set(np.unique(want["outlier_masks"])) <= {0, 1, 255}
        outliers += int((want["outlier_masks"] == 1).sum())
    assert outliers > 0


def _street_scenes(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(img, (np.repeat(np.repeat(rs.randint(0, 14, (8, 16)), 8, 0), 8, 1) + 1).astype(np.uint8))
            for img, _ in _scenes(n, seed)]


def test_street_hazards_mapper_bit_exact():
    cfg = tm.MapperConfig(**GEOMETRY)
    jmap = jm.StreetHazardsMapper(jm.MapperConfig(**GEOMETRY), seed=2)
    tmap = tm.StreetHazardsMapper(cfg, seed=2)
    assert tmap.cfg.ignore_label == 12 and cfg.ignore_label == 255  # forced on a copy
    for img, lab in _street_scenes(4):
        want = jmap(img, lab)
        _assert_same(tmap(img, lab), want)
        assert 12 not in want["gt_labels"][want["gt_valid"] > 0]


def test_street_hazards_coco_mix_mapper_bit_exact():
    objects = _objects(4)
    jmap = jm.StreetHazardsCocoMixMapper(jm.MapperConfig(**GEOMETRY), objects, ood_prob=0.7, seed=4)
    tmap = tm.StreetHazardsCocoMixMapper(tm.MapperConfig(**GEOMETRY), objects, ood_prob=0.7, seed=4)
    assert tmap.cfg.ignore_label == 12
    pasted = 0
    for img, lab in _street_scenes(6, seed=1):
        want = jmap(img, lab)
        _assert_same(tmap(img, lab), want)
        assert set(np.unique(want["outlier_masks"])) <= {0, 1, 12}
        pasted += int((want["outlier_masks"] == 1).any())
    assert pasted > 0

