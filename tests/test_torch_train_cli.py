"""``python -m rba_tpu_torch.train.train_net`` end to end on the CPU (``--device cpu``,
asked for explicitly) at the tiny config: a synthetic on-disk Cityscapes tree and a
COCO-proxy tree, the COCO-mix mapper, 2 steps, then ``--resume`` for a third;
``metrics.jsonl`` with finite losses, the checkpoints, and the last one's ``params.npz``
read by both packages.  A global batch that does not split over ``--num-gpus`` ranks is
refused (the trainer's evaluation is held in tests/test_torch_train_eval.py, several
GPUs in tests/test_torch_parallel.py)."""
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from rba_tpu import config as jconfig
from rba_tpu.convert.checkpoint import load_checkpoint_params as jload_checkpoint_params
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import load_checkpoint_params, model_to_jax_params
from rba_tpu_torch.train import train_net
from tests.torch_port_common import D2_TINY, tree_leaves


def _write_trees(root, n=4, hw=(48, 96)):
    rs = np.random.RandomState(0)
    for i in range(n):
        img_dir = root / "cityscapes" / "leftImg8bit" / "train" / "cityA"
        gt_dir = root / "cityscapes" / "gtFine" / "train" / "cityA"
        img_dir.mkdir(parents=True, exist_ok=True)
        gt_dir.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(img_dir / f"s{i}_leftImg8bit.png")
        lab = np.repeat(np.repeat(rs.randint(0, 7, (hw[0] // 8, hw[1] // 8)), 8, 0), 8, 1).astype(np.uint8)
        Image.fromarray(lab).save(gt_dir / f"s{i}_gtFine_labelTrainIds.png")
    ann, imgs = root / "coco" / "annotations" / "ood_seg_train2017", root / "coco" / "train2017"
    ann.mkdir(parents=True)
    imgs.mkdir(parents=True)
    for i in range(3):
        mask = np.zeros((24, 32), np.uint8)
        mask[4:16, 6:20] = 254
        Image.fromarray(mask).save(ann / f"{i:012d}.png")
        Image.fromarray(rs.randint(0, 256, (24, 32, 3)).astype(np.uint8)).save(imgs / f"{i:012d}.jpg")


def _config(path):
    d2 = json.loads(json.dumps(D2_TINY))
    d2["MODEL"]["MASK_FORMER"].update(OUTLIER_SUPERVISION=True, OUTLIER_LOSS_TARGET="nls", SCORE_NORM="tanh",
                                      OUTLIER_LOSS_FUNC="squared_hinge", TRAIN_NUM_POINTS=64)
    d2["INPUT"] = {"DATASET_MAPPER_NAME": "mask_former_semantic_coco_mix", "OOD_PROB": 1.0, "MIN_SIZE_TRAIN": [40, 48],
                   "MAX_SIZE_TRAIN": 200, "CROP": {"SIZE": [32, 64]}, "COLOR_AUG_SSD": False, "COCO_ROOT": "coco/"}
    d2["SOLVER"] = {"IMS_PER_BATCH": 2, "MAX_ITER": 3, "BASE_LR": 1e-4}
    d2["TEST"] = {"EVAL_PERIOD": 0}
    d2["DATALOADER"] = {"NUM_WORKERS": 2}
    path.write_text(yaml.safe_dump(d2))
    return path


def test_train_cli_end_to_end(tmp_path):
    _write_trees(tmp_path)
    cfg_path = _config(tmp_path / "config.yaml")
    out = tmp_path / "out"
    args = ["--config-file", str(cfg_path), "--data-root", str(tmp_path / "cityscapes"), "--output-dir", str(out),
            "--log-period", "1", "--checkpoint-period", "2", "--seed", "1", "--device", "cpu"]
    state = train_net.main(args + ["--max-iter", "2"])
    assert state.step == 2 and not next(state.model.parameters()).is_cuda
    ckpt = out / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["step_2"]
    state = train_net.main(args + ["--max-iter", "3", "--resume"])
    assert state.step == 3 and sorted(os.listdir(ckpt)) == ["step_2", "step_3"]

    lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [m["step"] for m in lines] == [1, 2, 3]
    for m in lines:
        assert "outlier_loss" in m and "loss_ce_0" in m and "grad_norm" in m
        assert all(np.isfinite(v) for k, v in m.items())
    assert sum(m["ood_images"] for m in lines) > 0  # OOD_PROB 1: pasted, unless the crop cut the object off

    # the checkpoint's params.npz: the port's serving loader and rba_tpu's loader
    tcfg = tconfig.load_d2_config(str(cfg_path))
    model = load_checkpoint_params(str(ckpt / "step_3"), tcfg, device="cpu")
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(state.model.named_parameters())[name]), name
    jparams = jload_checkpoint_params(str(ckpt / "step_3"), jconfig.load_d2_config(str(cfg_path)))
    got = dict(tree_leaves(model_to_jax_params(state.model)))
    want = dict(tree_leaves(jparams))
    assert sorted(got, key=str) == sorted(want, key=str)
    assert all(np.array_equal(got[k], np.asarray(want[k])) for k in want)
    step2 = load_checkpoint_params(str(ckpt / "step_2"), tcfg, device="cpu")
    assert any(not torch.equal(p, q) for p, q in zip(step2.parameters(), model.parameters()))


def test_train_cli_on_a_native_non_swin_recipe(tmp_path):
    """A native YAML (``save_config``'s format, as the non-Swin recipes under
    ``configs/cityscapes/semantic-segmentation/`` are): MiT-B0 under the narrow head with
    the coco-mix recipes' solver, backbone and pixel decoder frozen.  One step: finite
    losses with the outlier loss; the checkpoint keeps the frozen parameters of the seeded
    model bit for bit and moves the decoder's."""
    import dataclasses

    from rba_tpu_torch.models.maskformer import build_model
    from tests.torch_port_common import train_head_cfg

    _write_trees(tmp_path)
    cfg = train_head_cfg(tconfig, "mit_b0", freeze_backbone=True, freeze_pixel_decoder=True, ims_per_batch=2,
                         max_iter=1, num_workers=1)
    cfg = dataclasses.replace(
        cfg, input=dataclasses.replace(cfg.input, dataset_mapper_name="mask_former_semantic_coco_mix",
                                       min_size_train=(40, 48), max_size_train=200, crop_size=(32, 64),
                                       color_aug_ssd=False),
        ood=dataclasses.replace(cfg.ood, ood_prob=1.0), test=dataclasses.replace(cfg.test, eval_period=0))
    cfg_path = tmp_path / "mit_b0_coco_mix.yaml"
    tconfig.save_config(str(cfg_path), cfg)
    assert "MODEL" not in yaml.safe_load(cfg_path.read_text())
    out = tmp_path / "out"
    state = train_net.main(["--config-file", str(cfg_path), "--data-root", str(tmp_path / "cityscapes"),
                            "--output-dir", str(out), "--log-period", "1", "--seed", "1", "--device", "cpu"])
    assert state.step == 1
    (m,) = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert "outlier_loss" in m and all(np.isfinite(v) for v in m.values())
    start = dict(build_model(cfg, device="cpu", seed=1).named_parameters())
    trained = load_checkpoint_params(str(out / "checkpoints" / "step_1"), cfg, device="cpu")
    for name, p in trained.named_parameters():
        if name.startswith(("backbone.", "sem_seg_head.pixel_decoder.")):
            assert torch.equal(p, start[name]), name
        else:
            assert not torch.equal(p, start[name]), name


@pytest.mark.parametrize("extra,item", [(["--mapper", "mask_former_semantic_void"], "§A.4"),
                                        (["--num-gpus", "2"], "§A.8")])
def test_unported_paths_are_refused(tmp_path, extra, item):
    """Several GPUs (refused until §A.8 ported them) refuse a global batch that does not
    split over the ranks and micro-batches, before any rank starts
    (tests/test_torch_parallel.py trains on two); the void mapper, refused until §A.4
    ported it, trains a step: the labels read as Cityscapes labelIds, the void ids
    supervised as outliers."""
    _write_trees(tmp_path, n=2)
    args = ["--config-file", str(_config(tmp_path / "config.yaml")), "--data-root", str(tmp_path / "cityscapes"),
            "--output-dir", str(tmp_path / "out"), "--device", "cpu", "--max-iter", "1", "--log-period", "1"]
    if item == "§A.8":  # IMS_PER_BATCH 2 over 2 ranks x 2 micro-batches
        with pytest.raises(ValueError, match="does not split"):
            train_net.main(args + extra + ["--grad-accum", "2"])
        assert not (tmp_path / "out" / "metrics.jsonl").exists()
        return
    for gt in (tmp_path / "cityscapes" / "gtFine" / "train" / "cityA").iterdir():  # → labelIds: 5 classes, void
        lab = np.asarray(Image.open(gt))
        Image.fromarray(np.array([7, 8, 11, 13, 4, 5, 0], np.uint8)[lab]).save(gt)
    state = train_net.main(args + extra)
    assert state.step == 1
    (m,) = [json.loads(line) for line in open(tmp_path / "out" / "metrics.jsonl")]
    assert "outlier_loss" in m and all(np.isfinite(v) for v in m.values())
    assert "ood_images" in m  # the void mapper emits outlier_masks


def test_prefetching_iterator_stops_its_threads_when_closed():
    """Closing the batch iterator stops its coordinator and mapper threads; the batches
    before are those of the stream, in order."""
    import threading
    import time

    class Sample:
        def __init__(self, i):
            self.image, self.label = np.full((2, 2, 3), i, np.uint8), np.zeros((2, 2), np.int32)

    def mapper(image, label):
        return {"images": image.astype(np.float32)}

    before = set(threading.enumerate())
    it = train_net.prefetching_iterator([Sample(i) for i in range(6)], mapper, batch_size=2, seed=0, workers=3)
    first = [next(it)["images"][:, 0, 0, 0].tolist() for _ in range(3)]
    assert sorted(sum(first, [])) == [0, 1, 2, 3, 4, 5]  # one epoch, every sample once
    started = set(threading.enumerate()) - before
    assert len(started) == 4  # the coordinator and 3 mapper threads
    it.close()
    deadline = time.time() + 5
    while any(th.is_alive() for th in started) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(th.is_alive() for th in started)
