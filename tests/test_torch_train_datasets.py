"""The trainer on the recipes that read other datasets than Cityscapes, against
rba_tpu's trainer, on tiny Detectron2 YAMLs over synthetic on-disk trees:

- ``mapillary_concat``: the Mapillary fine-tune with Cityscapes (``DATASETS.TRAIN`` lists
  ``mapillary_cityscapes_sem_seg_train`` and ``cityscapes_fine_sem_seg_train``, one
  ``ConcatDataset``), COCO-mix mapper;
- ``coco_lsj``: the COCO open-panoptic recipe (``coco_2017_train_panoptic_open``,
  ``coco_panoptic_lsj``, ``DATASETS.UNSEEN_LABEL_SET``);
- ``mapillary_65``: Mapillary Vistas' 65 classes (``mapillary_vistas_sem_seg_train``,
  ``SemSegFolder``).

For each: the first two batches of ``data_iterator`` equal rba_tpu's bit for bit (one
mapper thread, the same seed), and one ``train_net.main`` step on the CPU.  Also one
train step on an LSJ panoptic batch, losses and gradients within 1e-4 of rba_tpu at fp32;
ROADMAP.md §C.16, Mapillary's void class 65 as a target; every shipped config's mapper and
dataset names; the unseen-label set against rba_tpu's."""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from rba_tpu import config as jconfig
from rba_tpu.train import train_net as jtrain_net
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.data import catalog as tcatalog
from rba_tpu_torch.data.categories import OPEN_PANOPTIC_UNKNOWN_CLASSES
from rba_tpu_torch.train import train_net
from tests.torch_port_common import (D2_TINY, LOSS_TOL, GRAD_TOL, catalogs_restored, d2_model_pair, grad_errors,
                                     port_loss_and_grads, rba_tpu_loss_and_grads, record)

HW = (64, 96)
UNKNOWN_CAR, PERSON, RIVER = 3, 1, 149  # raw COCO ids: an unknown thing of the open protocol, a thing, stuff
OUTLIER = dict(OUTLIER_SUPERVISION=True, OUTLIER_LOSS_TARGET="nls", SCORE_NORM="tanh",
               OUTLIER_LOSS_FUNC="squared_hinge", TRAIN_NUM_POINTS=64)
RECIPES = {
    "mapillary_concat": dict(
        classes=19, mask_former=OUTLIER,
        datasets={"TRAIN": ["mapillary_cityscapes_sem_seg_train", "cityscapes_fine_sem_seg_train"],
                  "TEST": ["mapillary_cityscapes_sem_seg_val"]},
        input={"DATASET_MAPPER_NAME": "mask_former_semantic_coco_mix", "OOD_PROB": 0.5, "MIN_SIZE_TRAIN": [40, 48],
               "MAX_SIZE_TRAIN": 8192, "CROP": {"SIZE": [32, 64]}, "COCO_ROOT": "coco/"}),
    "coco_lsj": dict(
        classes=117, mask_former={},
        datasets={"TRAIN": ["coco_2017_train_panoptic_open"], "TEST": ["coco_2017_val_panoptic_open"],
                  "UNSEEN_LABEL_SET": "datasets/unknown/unknown_K20.txt"},
        input={"DATASET_MAPPER_NAME": "coco_panoptic_lsj", "IMAGE_SIZE": 64, "MIN_SCALE": 0.1, "MAX_SCALE": 2.0}),
    "mapillary_65": dict(
        classes=65, mask_former={"NUM_OBJECT_QUERIES": 20},
        datasets={"TRAIN": ["mapillary_vistas_sem_seg_train"], "TEST": ["mapillary_vistas_sem_seg_val"]},
        input={"DATASET_MAPPER_NAME": "mask_former_semantic", "MIN_SIZE_TRAIN": [48, 64], "MAX_SIZE_TRAIN": 8192,
               "CROP": {"SIZE": [48, 48]}}),
}


def _save(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(array).save(path)


def _blocks(rs, high, block=8):
    return np.repeat(np.repeat(rs.randint(0, high, (HW[0] // block, HW[1] // block)), block, 0), block, 1)


def _write_trees(root):
    rs = np.random.RandomState(0)
    for i in range(3):  # Cityscapes train ids
        lab = _blocks(rs, 19).astype(np.uint8)
        lab[:4] = 255
        _save(root / "cityscapes" / "leftImg8bit" / "train" / "cityA" / f"c{i}_leftImg8bit.png",
              rs.randint(0, 256, (*HW, 3)).astype(np.uint8))
        _save(root / "cityscapes" / "gtFine" / "train" / "cityA" / f"c{i}_gtFine_labelTrainIds.png", lab)
    for folder in ("training", "validation"):  # Mapillary ids 0-65, 65 void
        for i in range(3):
            lab = _blocks(rs, 66, block=16).astype(np.uint8)
            lab[:8] = 65
            _save(root / "mapillary_vistas" / folder / "images" / f"m{i}.jpg",
                  rs.randint(0, 256, (*HW, 3)).astype(np.uint8))
            _save(root / "mapillary_vistas" / folder / "labels" / f"m{i}.png", lab)
    for i in range(3):  # COCO proxy objects
        mask = np.zeros((24, 32), np.uint8)
        mask[4:16, 6:20] = 254
        _save(root / "coco" / "annotations" / "ood_seg_train2017" / f"{i:012d}.png", mask)
        _save(root / "coco" / "train2017" / f"{i:012d}.jpg", rs.randint(0, 256, (24, 32, 3)).astype(np.uint8))
    images, anns = [], []  # COCO panoptic train2017, raw category ids
    for i in range(3):
        ids = np.zeros(HW, np.int64)
        segs = []
        for j, (cat, crowd) in enumerate(((UNKNOWN_CAR, 0), (PERSON, 0), (RIVER, 0), (PERSON, 1))):
            sid = 1000 * (j + 1) + i
            y, x = rs.randint(0, HW[0] - 20), rs.randint(0, HW[1] - 30)
            ids[y : y + 20, x : x + 30] = sid
            segs.append({"id": sid, "category_id": cat, "iscrowd": crowd, "area": 600})
        _save(root / "coco" / "train2017" / f"pan{i}.jpg", rs.randint(0, 256, (*HW, 3)).astype(np.uint8))
        _save(root / "coco" / "panoptic_train2017" / f"pan{i}.png",
              np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8))
        images.append({"id": i, "file_name": f"pan{i}.jpg"})
        anns.append({"image_id": i, "file_name": f"pan{i}.png", "segments_info": segs})
    (root / "coco" / "annotations" / "panoptic_train2017.json").write_text(
        json.dumps({"images": images, "annotations": anns}))
    (root / "unknown").mkdir()
    (root / "unknown" / "unknown_K20.txt").write_text("\n".join(OPEN_PANOPTIC_UNKNOWN_CLASSES) + "\n")


def _yaml(path, recipe):
    spec = RECIPES[recipe]
    d2 = json.loads(json.dumps(D2_TINY))
    d2["MODEL"]["SEM_SEG_HEAD"]["NUM_CLASSES"] = spec["classes"]
    d2["MODEL"]["MASK_FORMER"].update(spec["mask_former"])
    d2.update(DATASETS=spec["datasets"], INPUT=spec["input"], SOLVER={"IMS_PER_BATCH": 2, "MAX_ITER": 1},
              TEST={"EVAL_PERIOD": 0}, DATALOADER={"NUM_WORKERS": 1})
    path.write_text(yaml.safe_dump(d2))
    return str(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    _write_trees(root)
    return root


def _argv(trees, recipe, *extra):
    return ["--config-file", _yaml(trees / f"{recipe}.yaml", recipe), "--data-root", str(trees / "cityscapes"),
            "--seed", "4", *extra]


def _first_batches(trees, recipe, n=2):
    """The first ``n`` batches of both packages' ``data_iterator`` (one mapper thread)."""
    argv = _argv(trees, recipe, "--workers", "1")
    targs, jargs = train_net.parse_args(argv), jtrain_net.parse_args(argv)
    tcfg, jcfg = tconfig.load_config(targs.config_file), jconfig.load_d2_config(jargs.config_file)
    with catalogs_restored():
        it = train_net.data_iterator(tcfg, targs, 2)
        got = [next(it) for _ in range(n)]
        it.close()
        jit = jtrain_net.data_iterator(jcfg, jargs, 2)
        want = [next(jit) for _ in range(n)]
    return got, want


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_first_batches_equal_rba_tpu(trees, recipe):
    got, want = _first_batches(trees, recipe)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape and np.array_equal(g[k], w[k]), k
    labels = np.concatenate([b["gt_labels"][b["gt_valid"] > 0] for b in got])
    if recipe == "coco_lsj":  # the unknown things (255 in the open metadata) are never targets
        assert got[0]["images"].shape == (2, 64, 64, 3) and 255 not in labels and len(labels) > 0
    if recipe == "mapillary_concat":
        assert "outlier_masks" in got[0] and labels.max() < 19


def test_concat_of_train_names(trees):
    args = train_net.parse_args(_argv(trees, "mapillary_concat"))
    with catalogs_restored():
        ds = train_net.train_dataset(tconfig.load_config(args.config_file), args)
    assert [type(p).__name__ for p in ds.parts] == ["MapillarySemSeg", "CityscapesSemSeg"]
    assert len(ds) == 6


def test_a_missing_train_name_is_skipped(trees, tmp_path, capsys):
    """As rba_tpu's trainer: a name whose data is missing is skipped with a warning, and
    the trainer raises only where no name resolves."""
    args = train_net.parse_args(_argv(trees, "mapillary_concat"))
    cfg = tconfig.load_config(args.config_file)
    with catalogs_restored():
        args.data_root = str(tmp_path / "cityscapes")  # no Cityscapes and no Mapillary there
        with pytest.raises(FileNotFoundError, match="none of DATASETS.TRAIN"):
            train_net.train_dataset(cfg, args)
        (tmp_path / "mapillary_vistas").symlink_to(trees / "mapillary_vistas")
        ds = train_net.train_dataset(cfg, args)
    assert type(ds).__name__ == "MapillarySemSeg" and "cityscapes_fine_sem_seg_train" in capsys.readouterr().out


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_cli_step(trees, tmp_path, recipe):
    out = tmp_path / "out"
    with catalogs_restored():
        state = train_net.main(_argv(trees, recipe, "--output-dir", str(out), "--log-period", "1", "--device",
                                     "cpu"))
    assert state.step == 1
    (m,) = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert all(np.isfinite(v) for v in m.values())
    assert ("outlier_loss" in m) == (recipe == "mapillary_concat")
    assert (out / "checkpoints" / "step_1" / "params.npz").exists()


def test_lsj_panoptic_step_matches_rba_tpu(trees, request):
    """One step of the tiny config (117 classes, fp32) on the first LSJ panoptic batch:
    every loss and every gradient within 1e-4 of rba_tpu's, relative as in the train-step
    tests (a loss to max(1, |loss|), a gradient to its leaf's largest magnitude)."""
    batch = _first_batches(trees, "coco_lsj", n=1)[0][0]
    jcfg = jconfig.tiny_test_config(num_classes=117)
    tcfg = tconfig.tiny_test_config(num_classes=117)
    params, model = d2_model_pair(jcfg, tcfg, seed=2)
    key = jax.random.PRNGKey(7)
    want, want_grads, _ = rba_tpu_loss_and_grads(jcfg, params, batch, key)
    got, got_grads = port_loss_and_grads(tcfg, model, batch, key)
    assert sorted(got) == sorted(want) and "loss_mask" in got
    loss_err = max(abs(got[k] - w) / max(1.0, abs(w)) for k, w in want.items())
    errs = grad_errors(got_grads, want_grads)
    record(request, loss_rel_err=loss_err, grad_rel_err=max(errs.values()))
    assert loss_err <= LOSS_TOL
    assert max(errs.values()) <= GRAD_TOL, max(errs, key=errs.get)


def test_mapillary_void_is_a_target_as_in_rba_tpu(trees):
    """ROADMAP.md §C.16: the 65-class recipe's mapper takes ``ignore_label`` 255 from
    ``sem_seg_head_ignore_value``, while the dataset's void id is 65; so void pixels make
    class-65 targets, the "no object" index at 65 classes.  Both packages do so."""
    got, want = _first_batches(trees, "mapillary_65", n=1)
    for b in (got[0], want[0]):
        assert 65 in b["gt_labels"][b["gt_valid"] > 0]
    cfg = tconfig.load_config(_yaml(trees / "m65.yaml", "mapillary_65"))
    assert cfg.sem_seg_head_ignore_value == 255 and cfg.num_classes == 65


def test_65_class_evaluation_counts_void_nowhere(trees):
    """The mIoU of the 65-class recipe: a pixel labelled 65 (or 255) lands in no cell of
    the confusion matrix, as rba_tpu's ``bincount`` drops it; ``run_val_eval`` reads
    ``mapillary_vistas_sem_seg_val``."""
    from rba_tpu_torch.evalx.seg_evaluators import confusion_counts
    from rba_tpu_torch.models.maskformer import build_model

    rs = np.random.RandomState(1)
    label = rs.randint(0, 66, (16, 24))
    label[0] = 255
    pred = torch.from_numpy(rs.randint(0, 65, (16, 24)))
    counts = confusion_counts(pred, torch.from_numpy(label), 65).numpy()
    valid = label < 65
    want = np.bincount(label[valid] * 65 + pred.numpy()[valid], minlength=65 * 65).reshape(65, 65)
    assert np.array_equal(counts, want) and counts.sum() == valid.sum() < label.size
    cfg = tconfig.load_config(_yaml(trees / "m65_eval.yaml", "mapillary_65"))
    model = build_model(cfg, device="cpu", seed=0)
    with catalogs_restored():
        res = train_net.run_val_eval(cfg, model, str(trees / "cityscapes"), max_images=2)
    assert res["eval_images"] == 2 and np.isfinite(res["mIoU"])


CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.mark.parametrize("path", sorted(CONFIGS.rglob("*.yaml")), ids=lambda p: p.relative_to(CONFIGS).as_posix())
def test_every_shipped_config_has_its_mapper_and_names(tmp_path, path):
    """The trainer builds every shipped config's mapper (the class rba_tpu's trainer
    builds), and every DATASETS.TRAIN / TEST name of it is registered."""
    (tmp_path / "coco" / "annotations" / "ood_seg_train2017").mkdir(parents=True)
    cfg = tconfig.load_config(str(path))
    args = train_net.parse_args(["--config-file", str(path), "--data-root", str(tmp_path / "cityscapes"),
                                 "--coco-root", str(tmp_path / "coco")])
    jargs = jtrain_net.parse_args(["--config-file", str(path), "--data-root", str(tmp_path / "cityscapes"),
                                   "--coco-root", str(tmp_path / "coco")])
    with catalogs_restored():
        mapper = train_net.build_mapper(cfg, args)
        # rba_tpu reads a native YAML as a Detectron2 one (ROADMAP.md §C.13): give it the INPUT section
        want = jtrain_net.build_mapper(dataclasses.replace(jconfig.load_d2_config(str(path)), input=cfg.input), jargs)
        tcatalog.register_standard_datasets(str(tmp_path))
        names = set(tcatalog.registered())
    assert type(mapper).__name__ == type(want).__name__
    assert set(cfg.datasets_train) | set(cfg.datasets_test) <= names


@pytest.mark.parametrize("spelling", ["datasets/unknown/unknown_K20.txt", "unknown/unknown_K20.txt"])
@pytest.mark.parametrize("train_name", ["coco_2017_train_panoptic", "coco_2017_train_panoptic_open"])
def test_unseen_label_set_equals_rba_tpus(trees, spelling, train_name):
    """Both path spellings, resolved against the first train name's ``thing_classes``: the
    closed metadata names the 16 unknown classes, the open one leaves them out (then the
    set is empty and the unknown things reach the mapper as 255)."""
    argv = _argv(trees, "coco_lsj")
    targs, jargs = train_net.parse_args(argv), jtrain_net.parse_args(argv)
    tcfg, jcfg = tconfig.load_config(targs.config_file), jconfig.load_d2_config(jargs.config_file)
    tcfg = dataclasses.replace(tcfg, unseen_label_set=spelling, datasets_train=(train_name,))
    jcfg = dataclasses.replace(jcfg, unseen_label_set=spelling, datasets_train=(train_name,))
    with catalogs_restored():
        got, want = train_net._unseen_label_set(tcfg, targs), jtrain_net._unseen_label_set(jcfg, jargs)
    assert got == want
    assert len(got) == (16 if train_name == "coco_2017_train_panoptic" else 0)
