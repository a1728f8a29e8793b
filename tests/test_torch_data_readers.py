"""The port's dataset readers against rba_tpu's on one synthetic on-disk tree of each
dataset's layout: every sample (image, label, name; a panoptic reader's image, id map
and segments) equal, and the readers' file lists equal.  Covers ``MapillarySemSeg`` in
both taxonomies, ``SemSegFolder`` (Mapillary's 65 classes, COCO-Stuff-10k,
StreetHazards' training split), ``ConcatDataset`` indexed across its parts, the Mapillary
panoptic reader, ``StreetHazards``, ``SmallObstacles``, ``CityscapesC``,
``CityscapesIncremental`` and ``get_datasets``."""
import json

import numpy as np
import pytest
from PIL import Image

from rba_tpu.data import catalog as jcatalog
from rba_tpu.data import ood_datasets as jds
from rba_tpu_torch.data import catalog as tcatalog
from rba_tpu_torch.data import ood_datasets as tds
from tests.torch_port_common import catalogs_restored

HW = (40, 56)


def _save(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(array).save(path)


def _image(rs):
    return rs.randint(0, 256, (*HW, 3)).astype(np.uint8)


def _blocks(rs, high, block=8):
    return np.repeat(np.repeat(rs.randint(0, high, (HW[0] // block, HW[1] // block)), block, 0), block, 1)


def _write_mapillary(root, rs):
    mapi = root / "mapillary_vistas"
    for folder, n in (("training", 3), ("validation", 2)):
        for i in range(n):
            _save(mapi / folder / "images" / f"m{folder[0]}{i}.jpg", _image(rs))
            lab = _blocks(rs, 66).astype(np.uint8)
            lab[:4] = 65  # void--unlabeled
            _save(mapi / folder / "labels" / f"m{folder[0]}{i}.png", lab)
    # panoptic: RGB id maps and panoptic_2018.json with Mapillary's panoptic category ids
    anns, images = [], []
    for i in range(2):
        ids = np.zeros(HW, np.int64)
        segs = []
        for j, cat in enumerate((20, 3, 56)):  # Person (thing), Curb (stuff), Car (thing)
            sid = 300 * (j + 1) + 7 * i + 1
            ids[8 * j : 8 * j + 10, 4 + 6 * i : 30] = sid
            segs.append({"id": sid, "category_id": cat, "iscrowd": 0, "area": 1})
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        _save(mapi / "validation" / "panoptic" / f"mv{i}.png", rgb)
        images.append({"id": f"mv{i}", "file_name": f"mv{i}.jpg"})
        anns.append({"image_id": f"mv{i}", "file_name": f"mv{i}.png", "segments_info": segs})
    (mapi / "validation" / "panoptic" / "panoptic_2018.json").write_text(json.dumps(
        {"images": images, "annotations": anns}))


def _write_cityscapes(root, rs):
    cs = root / "cityscapes"
    for i in range(3):
        base = f"cityA_{i:06d}"
        _save(cs / "leftImg8bit" / "val" / "cityA" / f"{base}_leftImg8bit.png", _image(rs))
        # Cityscapes-C: the corrupted frames beside the clean labels, in a root of its own
        _save(root / "cityscapes_c" / "leftImg8bit" / "val" / "cityA" / "gaussian_noise" / "2"
              / f"{base}_leftImg8bit.png", _image(rs))
        if i < 2:  # train ids; the third frame has only labelIds
            lab = _blocks(rs, 19).astype(np.uint8)
            lab[:4] = 255
            _save(cs / "gtFine" / "val" / "cityA" / f"{base}_gtFine_labelTrainIds.png", lab)
        else:
            _save(cs / "gtFine" / "val" / "cityA" / f"{base}_gtFine_labelIds.png", _blocks(rs, 34).astype(np.uint8))
        for gt in (cs / "gtFine" / "val" / "cityA").glob(f"{base}_*"):
            _save(root / "cityscapes_c" / "gtFine" / "val" / "cityA" / gt.name, np.asarray(Image.open(gt)))
        _save(cs / "leftImg8bit" / "train" / "cityA" / f"{base}_leftImg8bit.png", _image(rs))
        _save(cs / "gtFine" / "train" / "cityA" / f"{base}_gtFine_labelTrainIds.png", _blocks(rs, 19).astype(np.uint8))


def _write_street_hazards(root, rs):
    for i in range(3):  # the OOD test set: 1-based ids, the anomaly 14 on a block
        lab = _blocks(rs, 13).astype(np.uint8) + 1
        lab[10:20, 10:30] = 14
        _save(root / "street_hazards" / "images" / "test" / "t5" / f"{i:03d}.png", _image(rs))
        _save(root / "street_hazards" / "annotations" / "test" / "t5" / f"{i:03d}.png", lab)
    for i in range(2):  # the training split of the semantic names
        _save(root / "StreetHazards" / "train" / "images" / f"s{i}.png", _image(rs))
        _save(root / "StreetHazards" / "train" / "annotations" / f"s{i}.png", (_blocks(rs, 14) + 1).astype(np.uint8))
    _save(root / "StreetHazards" / "train" / "images" / "unlabelled.png", _image(rs))  # no label: not read


def _write_small_obstacles(root, rs):
    colours = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0], [0, 0, 128]], np.uint8)
    for seq in ("seq1", "seq2"):
        for i in range(2):
            _save(root / "small_obstacles" / "val" / seq / "image" / f"{i:04d}.png", _image(rs))
            _save(root / "small_obstacles" / "val" / seq / "labels" / f"{i:04d}.png", colours[_blocks(rs, 4)])


def _write_coco_stuff(root, rs):
    base = root / "coco" / "coco_stuff_10k"
    for split in ("train", "test"):
        for i in range(2):
            _save(base / "images_detectron2" / split / f"c{i}.jpg", _image(rs))
            _save(base / "annotations_detectron2" / split / f"c{i}.png", _blocks(rs, 171).astype(np.uint8))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    rs = np.random.RandomState(0)
    for write in (_write_mapillary, _write_cityscapes, _write_street_hazards, _write_small_obstacles,
                  _write_coco_stuff):
        write(root, rs)
    return root


def _assert_readers_equal(got, want, at_least: int = 1):
    assert len(got) == len(want) >= at_least
    for i in range(len(want)):
        a, b = got[i], want[i]
        if isinstance(b, tuple):  # a panoptic reader: (image, ids, segments)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
            assert a[1].dtype == b[1].dtype
            continue
        assert a.name == b.name
        for x, y in ((a.image, b.image), (a.label, b.label)):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("cityscapes_taxonomy", [True, False])
def test_mapillary_semseg(tree, mode, cityscapes_taxonomy):
    got = tds.MapillarySemSeg(str(tree / "mapillary_vistas"), mode, cityscapes_taxonomy)
    want = jds.MapillarySemSeg(str(tree / "mapillary_vistas"), mode, cityscapes_taxonomy)
    _assert_readers_equal(got, want, at_least=2)
    labels = np.concatenate([got[i].label.ravel() for i in range(len(got))])
    if cityscapes_taxonomy:  # 19 train ids and void
        assert set(labels) <= set(range(19)) | {255}
    else:
        assert labels.max() == 65  # the raw ids, void included


@pytest.mark.parametrize("name", ["mapillary_vistas_sem_seg_train", "mapillary_vistas_sem_seg_val",
                                  "coco_2017_train_stuff_10k_sem_seg", "coco_2017_test_stuff_10k_sem_seg",
                                  "street_hazards_sem_seg_train", "street_hazards_sem_seg_val",
                                  "mapillary_cityscapes_sem_seg_train", "street_hazards_test",
                                  "mapillary_vistas_panoptic_val"])
def test_catalog_readers(tree, name):
    with catalogs_restored():
        tcatalog.register_standard_datasets(str(tree))
        jcatalog.register_standard_datasets(str(tree))
        got, want = tcatalog.get(name), jcatalog.get(name)
        assert type(got).__name__ == type(want).__name__
        _assert_readers_equal(got, want, at_least=2)


def test_mapillary_panoptic_segments(tree):
    """The raw Mapillary panoptic ids become the contiguous ids of the table, with isthing."""
    with catalogs_restored():
        tcatalog.register_standard_datasets(str(tree))
        _, pan, segments = tcatalog.get("mapillary_vistas_panoptic_val")[0]
    assert [(s["category_id"], s["isthing"]) for s in segments] == [(19, True), (2, False), (55, True)]
    assert all((pan == s["id"]).any() for s in segments)


def test_concat_dataset_indexes_across_parts(tree):
    parts = [(m.MapillarySemSeg(str(tree / "mapillary_vistas"), "train"),
              m.CityscapesSemSeg(str(tree / "cityscapes"), "train")) for m in (tds, jds)]
    got, want = tds.ConcatDataset(parts[0]), jds.ConcatDataset(parts[1])
    assert len(got) == len(parts[0][0]) + len(parts[0][1]) == 6
    _assert_readers_equal(got, want, at_least=6)
    assert [got[i].name[:2] for i in range(6)] == ["mt"] * 3 + ["ci"] * 3  # part after part
    assert got[4].name == parts[0][1][1].name and got[2].name == parts[0][0][2].name
    nested = tds.ConcatDataset([got, parts[0][1]])
    assert len(nested) == 9 and nested[7].name == parts[0][1][1].name


def test_street_hazards(tree):
    got, want = tds.StreetHazards(str(tree / "street_hazards")), jds.StreetHazards(str(tree / "street_hazards"))
    _assert_readers_equal(got, want, at_least=3)
    assert got.images == want.images
    assert set(np.unique(got[0].label)) == {0, 1} and got[0].label[10:20, 10:30].all()


def test_small_obstacles(tree):
    got = tds.SmallObstacles(str(tree / "small_obstacles"))
    want = jds.SmallObstacles(str(tree / "small_obstacles"))
    _assert_readers_equal(got, want, at_least=4)
    assert set(np.unique(np.concatenate([got[i].label.ravel() for i in range(4)]))) == {0, 1, 255}


@pytest.mark.parametrize("reader", ["CityscapesC", "CityscapesIncremental"])
def test_cityscapes_variants(tree, reader):
    kw = dict(distortion="gaussian_noise", severity="2") if reader == "CityscapesC" else dict(holdout_classes=(3, 5))
    root = str(tree / ("cityscapes_c" if reader == "CityscapesC" else "cityscapes"))
    got, want = getattr(tds, reader)(root, "val", **kw), getattr(jds, reader)(root, "val", **kw)
    _assert_readers_equal(got, want, at_least=3)
    if reader == "CityscapesIncremental":
        assert set(np.unique(got[0].label)) <= {0, 1, 255} and (got[0].label == 1).any()


def test_semseg_folder_missing_dirs(tmp_path):
    for root in (tmp_path / "none", tmp_path):
        assert len(tds.SemSegFolder(str(root), str(tmp_path / "labels"))) == 0


def test_get_datasets(tree):
    got, want = tds.get_datasets(str(tree)), jds.get_datasets(str(tree))
    assert sorted(got) == sorted(want) == ["cityscapes"]  # rba_tpu's has no StreetHazards entry
    _assert_readers_equal(got["cityscapes"], want["cityscapes"], at_least=3)
