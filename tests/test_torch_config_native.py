"""The native config format, the dataset catalog and the panoptic readers of the port
against rba_tpu's: ``load_config`` of every YAML in configs/ gives rba_tpu's
``config_to_dict``, ``save_config`` round-trips, the catalog's metadata is rba_tpu's, and
``PanopticDataset`` / ``InstanceFromPanoptic`` / ``SemSegFromPanoptic`` read what rba_tpu's
read."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rba_tpu import config as jconfig
from rba_tpu.data import catalog as jcatalog
from rba_tpu.data import ood_datasets as jds
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.data import catalog as tcatalog
from rba_tpu_torch.data import ood_datasets as tds
from rba_tpu_torch.models.maskformer import RbAModel
from tests.torch_port_common import catalogs_restored

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
ALL_CONFIGS = sorted(CONFIGS.rglob("*.yaml"))
COCO_OPEN = CONFIGS / "coco" / "open-panoptic-segmentation" / "swin" / "maskformer2_swin_base_IN21k_384_bs16_50ep.yaml"


@pytest.fixture(autouse=True)
def _restore_catalogs():
    with catalogs_restored():
        yield


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=lambda p: p.relative_to(CONFIGS).as_posix())
def test_load_config_equals_rba_tpu(path, tmp_path):
    """Native and Detectron2 YAMLs alike: the port's config, written as a dict, is
    rba_tpu's; and save_config → load_config gives it back."""
    got = tconfig.load_config(str(path))
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(jconfig.load_config(str(path)))
    tconfig.save_config(str(tmp_path / "c.yaml"), got)
    assert tconfig.load_config(str(tmp_path / "c.yaml")) == got
    assert jconfig.load_config(str(tmp_path / "c.yaml")) == jconfig.load_config(str(path))


def test_coco_open_panoptic_swin_b_config():
    """The three-level Swin-B config: it loads as Swin-B with res3-res5 deformable levels,
    9 decoder layers, 117 classes and PANOPTIC_ON, and the port runs it."""
    cfg = tconfig.load_config(str(COCO_OPEN))
    assert cfg.swin == tconfig.swin_b_1dl().swin
    assert cfg.pixel_decoder.transformer_in_features == ("res3", "res4", "res5")
    assert (cfg.decoder.num_feature_levels, cfg.decoder.dec_layers, cfg.num_classes) == (3, 9, 117)
    assert cfg.test.panoptic_on and not cfg.test.semantic_on
    assert cfg.datasets_test == ("coco_2017_val_panoptic_open",)
    tconfig.check_supported(cfg)


def test_load_config_overrides_and_refusals(tmp_path):
    cfg = tconfig.load_config(str(COCO_OPEN), compute_dtype="float32")
    assert cfg.compute_dtype == "float32"
    r50 = tconfig.load_config(str(CONFIGS / "coco" / "open-panoptic-segmentation" / "maskformer2_R50_bs16_50ep.yaml"))
    assert (r50.backbone_name, r50.resnet.depth) == ("resnet", 50)
    tconfig.check_supported(r50)  # the COCO open-panoptic R50 loads and builds (ResNet is ported)
    with torch.device("meta"):
        RbAModel(r50)
    with pytest.raises(NotImplementedError, match="backbone 'resnet18_basic'"):
        tconfig.check_supported(dataclasses.replace(r50, backbone_name="resnet18_basic"))


@pytest.mark.parametrize("open_panoptic", [False, True])
def test_coco_panoptic_metadata_equals_rba_tpu(open_panoptic):
    got = tcatalog.coco_panoptic_metadata(open_panoptic)
    assert got == jcatalog.coco_panoptic_metadata(open_panoptic)
    if open_panoptic:  # 117 known classes, 16 unknown things at 255
        assert len(got["thing_classes"]) + len(got["stuff_dataset_id_to_contiguous_id"]) == 117
        assert sum(v == 255 for v in got["thing_dataset_id_to_contiguous_id"].values()) == 16


def test_standard_registrations(tmp_path):
    """The same names as rba_tpu's, with rba_tpu's metadata; the Mapillary Vistas
    65-class reader gives rba_tpu's samples on a small tree."""
    rs = np.random.RandomState(0)
    for folder in ("images", "labels"):
        (tmp_path / "mapillary_vistas" / "validation" / folder).mkdir(parents=True)
    for i in range(2):
        Image.fromarray(rs.randint(0, 256, (16, 24, 3)).astype(np.uint8)).save(
            tmp_path / "mapillary_vistas" / "validation" / "images" / f"v{i}.jpg")
        Image.fromarray(rs.randint(0, 66, (16, 24)).astype(np.uint8)).save(
            tmp_path / "mapillary_vistas" / "validation" / "labels" / f"v{i}.png")
    tcatalog.register_standard_datasets(str(tmp_path))
    jcatalog.register_standard_datasets(str(tmp_path))
    assert tcatalog.registered() == jcatalog.registered()
    for name in ("cityscapes_fine_sem_seg_val", "coco_2017_val_panoptic_open", "coco_2017_val_panoptic",
                 "mapillary_cityscapes_sem_seg_val", "road_anomaly", "mapillary_vistas_sem_seg_val"):
        assert tcatalog.metadata(name) == jcatalog.metadata(name), name
    got, want = tcatalog.get("mapillary_vistas_sem_seg_val"), jcatalog.get("mapillary_vistas_sem_seg_val")
    assert len(got) == len(want) == 2 and tcatalog.metadata("mapillary_vistas_sem_seg_val")["ignore_label"] == 65
    for i in range(2):
        assert got[i].name == want[i].name
        assert np.array_equal(got[i].image, want[i].image) and np.array_equal(got[i].label, want[i].label)
    with pytest.raises(KeyError):
        tcatalog.get("no_such_dataset")


def _write_coco_panoptic(root: Path, n: int = 3, hw=(24, 32)):
    """A COCO-format panoptic split under ``root/coco``: val2017 images, RGB id maps and
    annotations/panoptic_val2017.json, with raw COCO category ids (car, an unknown thing of
    the open protocol; person; road, stuff; and a crowd person)."""
    rs = np.random.RandomState(0)
    img_dir, pan_dir, ann_dir = root / "coco" / "val2017", root / "coco" / "panoptic_val2017", root / "coco" / "annotations"
    for d in (img_dir, pan_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        ids = np.zeros(hw, np.int64)
        segs = []
        for j, (cat, crowd) in enumerate(((3, 0), (1, 0), (149, 0), (1, 1))):
            sid = 1000 * (j + 1) + i
            y, x = rs.randint(0, hw[0] - 6), rs.randint(0, hw[1] - 6)
            ids[y : y + 6, x : x + 8] = sid
            segs.append({"id": sid, "category_id": cat, "iscrowd": crowd, "area": 48})
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        Image.fromarray(rgb).save(pan_dir / f"{i:012d}.png")
        Image.fromarray(rs.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(img_dir / f"{i:012d}.jpg")
        images.append({"id": i, "file_name": f"{i:012d}.jpg"})
        anns.append({"image_id": i, "file_name": f"{i:012d}.png", "segments_info": segs})
    (ann_dir / "panoptic_val2017.json").write_text(json.dumps({"images": images, "annotations": anns}))


def test_panoptic_readers_equal_rba_tpu(tmp_path):
    _write_coco_panoptic(tmp_path)
    for cat in (tcatalog, jcatalog):
        cat.register_standard_datasets(str(tmp_path))
    name = "coco_2017_val_panoptic_open"
    got, want = tcatalog.get(name), jcatalog.get(name)
    assert isinstance(got, tds.PanopticDataset) and len(got) == len(want) == 3
    thing_ids = sorted(v for v in set(tcatalog.metadata(name)["thing_dataset_id_to_contiguous_id"].values()) if v != 255)
    for i in range(len(got)):
        (gi, gp, gs), (wi, wp, ws) = got[i], want[i]
        assert np.array_equal(gi, wi) and np.array_equal(gp, wp) and gs == ws
        assert any(s["category_id"] == 255 for s in gs)  # car is unknown in the open protocol
        gi, gm, gc = tds.InstanceFromPanoptic(got, thing_ids)[i]
        wi, wm, wc = jds.InstanceFromPanoptic(want, thing_ids)[i]
        assert np.array_equal(gm, wm) and np.array_equal(gc, wc) and gc.dtype == np.int32
        g, w = tds.SemSegFromPanoptic(got)[i], jds.SemSegFromPanoptic(want)[i]
        assert np.array_equal(g.image, w.image) and np.array_equal(g.label, w.label)
