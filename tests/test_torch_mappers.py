"""``data/mappers.py`` against ``rba_tpu/data/mappers.py``: the semantic and the COCO-mix
training mappers on synthetic arrays, the same seed in both packages, every output array
equal bit for bit (numpy, PIL and ``random.Random`` on both sides); the COCO proxy
reader on an on-disk tree."""
import numpy as np
import pytest
from PIL import Image

from rba_tpu.data import mappers as jm
from rba_tpu_torch.data import mappers as tm

GEOMETRY = dict(min_sizes=(40, 56, 72), max_size=256, crop_hw=(40, 72), max_instances=6)


def _scenes(n, seed=0, hw=(64, 128), classes=8):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rs.randint(0, 256, (*hw, 3)).astype(np.uint8)
        sem = np.repeat(np.repeat(rs.randint(0, classes, (hw[0] // 8, hw[1] // 8)), 8, 0), 8, 1).astype(np.uint8)
        sem[:4] = 255
        out.append((img, sem))
    return out


def _objects(n, seed=1):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)
        mask = np.zeros((30, 40), np.int32)
        y, x = rs.randint(0, 15), rs.randint(0, 20)
        mask[y : y + 12, x : x + 16] = 254
        out.append((img, mask))
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("color_aug", [True, False])
def test_semantic_mapper_bit_exact(color_aug):
    jmap = jm.SemanticDatasetMapper(jm.MapperConfig(color_aug=color_aug, **GEOMETRY), seed=4)
    tmap = tm.SemanticDatasetMapper(tm.MapperConfig(color_aug=color_aug, **GEOMETRY), seed=4)
    for img, sem in _scenes(6):
        _assert_same(tmap(img, sem), jmap(img, sem))


def test_coco_mix_mapper_bit_exact():
    objects = _objects(5)
    jmap = jm.SemanticCocoMixDatasetMapper(jm.MapperConfig(**GEOMETRY), objects, ood_prob=0.6, seed=7)
    tmap = tm.SemanticCocoMixDatasetMapper(tm.MapperConfig(**GEOMETRY), objects, ood_prob=0.6, seed=7)
    pasted = 0
    for img, sem in _scenes(8, seed=2):
        want = jmap(img, sem)
        _assert_same(tmap(img, sem), want)
        pasted += int((want["outlier_masks"] == 1).any())
    assert pasted > 0
    batch = tm.collate([tmap(img, sem) for img, sem in _scenes(2, seed=3)])
    assert batch["gt_masks"].shape == (2, 6, 40, 72) and batch["outlier_masks"].shape == (2, 40, 72)


def test_coco_proxy_reader(tmp_path):
    (tmp_path / "annotations" / "ood_seg_train2017").mkdir(parents=True)
    (tmp_path / "train2017").mkdir()
    for i, (img, mask) in enumerate(_objects(4)):
        Image.fromarray(img).save(tmp_path / "train2017" / f"{i:012d}.jpg")
        Image.fromarray(mask.astype(np.uint8)).save(tmp_path / "annotations" / "ood_seg_train2017" / f"{i:012d}.png")
    jds, tds = jm.COCOProxyDataset(str(tmp_path), proxy_size=3), tm.COCOProxyDataset(str(tmp_path), proxy_size=3)
    assert len(tds) == len(jds) == 3 and tds.images == jds.images
    for i in range(3):
        (a, b), (c, d) = tds[i], jds[i]
        assert np.array_equal(a, c) and np.array_equal(b, d) and b.dtype == np.int32
