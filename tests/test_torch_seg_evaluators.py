"""The port's evaluators (``rba_tpu_torch/evalx/seg_evaluators.py``) and the
``eval_semseg`` CLI against rba_tpu's on the CPU, on a tiny model converted from one
seeded Detectron2 dict, at fp32:

- ``SemSegEvaluator``: the confusion counts equal, count for count (labels 255 and
  labels outside the classes not counted), so mIoU, fwIoU and pACC equal;
- ``OpenPanopticEvaluator`` (closed and open) and ``InstanceEvaluator``: PQ and mask AP
  equal; the open branch's map through Kernel B's plain version on the padded
  low-resolution logits equals the plain map of the upsampled logits within 1e-5;
- ``mask_average_precision`` and ``open_world_ap`` equal on seeded detections;
- ``python -m rba_tpu_torch.evalx.eval_semseg --device cpu --precision fp32`` writes the
  JSON of rba_tpu's CLI (its ``load_model`` at fp32) on the same tree and params.npz.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from rba_tpu import config as jconfig
from rba_tpu.evalx import eval_semseg as jcli
from rba_tpu.evalx import seg_evaluators as jse
from rba_tpu.evalx import sweep as jsweep
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import model_to_jax_params, save_params
from rba_tpu_torch.evalx import eval_semseg as tcli
from rba_tpu_torch.evalx import seg_evaluators as tse
from rba_tpu_torch.models.inference import open_rba_map
from tests.torch_port_common import D2_TINY, d2_model_pair, max_abs

HW = (40, 60)
RBA_TOL = 1e-5


def _low_threshold(pkg):
    """The tiny config with thresholds that let its random-weight queries make segments."""
    cfg = pkg.tiny_test_config()
    return dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, object_mask_threshold=0.05,
                                                             overlap_threshold=0.3))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _low_threshold(jconfig), _low_threshold(tconfig)
    params, model = d2_model_pair(jcfg, tcfg, seed=3)
    return jcfg, tcfg, params, model


def _frames(n=2, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        image = rs.randint(0, 256, (*HW, 3)).astype(np.uint8)
        label = np.repeat(np.repeat(rs.randint(0, 7, (HW[0] // 10, HW[1] // 10)), 10, 0), 10, 1).astype(np.int32)
        label[:5] = 255
        label[-3:, :7] = 250  # outside the 7 classes: not counted
        out.append((image, label))
    return out


def test_semseg_confusion_equals_rba_tpu(tiny):
    jcfg, tcfg, params, model = tiny
    jev, tev = jse.SemSegEvaluator(jcfg, params), tse.SemSegEvaluator(tcfg, model)
    for image, label in _frames():
        jev.process(image, label)
        tev.process(image, label)
    assert tev.conf.dtype == np.int64 and np.array_equal(tev.conf, jev.conf)
    assert tev.conf.sum() == sum(int(((lab != 255) & (lab < 7)).sum()) for _, lab in _frames())
    assert tev.evaluate() == jev.evaluate()


def _panoptic_gt(label):
    """Panoptic ground truth from a class map: each class is one segment; classes 5 and 6
    are things."""
    pan = np.where(label == 255, 0, label + 1).astype(np.int64)
    pan[label == 250] = 0
    segs = [{"id": int(c) + 1, "category_id": int(c), "isthing": int(c) >= 5}
            for c in np.unique(label) if c < 7]
    return pan, segs


@pytest.mark.parametrize("open_panoptic", [False, True])
def test_open_panoptic_evaluator_equals_rba_tpu(tiny, open_panoptic):
    jcfg, tcfg, params, model = tiny
    kw = dict(thing_ids=(5, 6), open_panoptic=open_panoptic, ood_threshold=-1.0, pixel_min=20)
    jev, tev = jse.OpenPanopticEvaluator(jcfg, params, **kw), tse.OpenPanopticEvaluator(tcfg, model, **kw)
    for image, label in _frames():
        pan, segs = _panoptic_gt(label)
        jev.process(image, pan, segs)
        tev.process(image, pan, segs)
    for (gp, gs, _, _), (wp, ws, _, _) in zip(tev.pairs, jev.pairs):
        assert np.array_equal(gp, wp) and gs == ws
    assert sum(len(p[1]) for p in tev.pairs) > 0
    assert tev.evaluate() == jev.evaluate()


def test_open_branch_map_through_kernel_b_plain(tiny):
    """On the CPU the open branch's map is Kernel B's plain version on the padded stride-4
    logits, cropped: the plain map of the upsampled, cropped logits within 1e-5."""
    _, tcfg, _, model = tiny
    ev = tse.OpenPanopticEvaluator(tcfg, model, open_panoptic=True)
    image = _frames(1)[0][0]
    mask_cls, low, mask_pred = ev.raw_outputs(image)
    assert low.shape[-2:] == (16, 16) and mask_pred.shape[-2:] == HW  # 40x60 pads to 64x64
    got = ev.rba_map(mask_cls, low, HW)
    assert got.shape == HW and max_abs(got, open_rba_map(mask_cls, mask_pred)) <= RBA_TOL


def test_instance_evaluator_equals_rba_tpu(tiny):
    jcfg, tcfg, params, model = tiny
    jev, tev = jse.InstanceEvaluator(jcfg, params, topk=20), tse.InstanceEvaluator(tcfg, model, topk=20)
    for image, label in _frames():
        masks = np.stack([(label == c) for c in (5, 6, 2)]).astype(np.uint8)
        classes = np.array([5, 6, 2], np.int32)
        jev.process(image, masks, classes)
        tev.process(image, masks, classes)
    for g, w in zip(tev.preds, jev.preds):
        assert np.array_equal(g["pred_classes"], np.asarray(w["pred_classes"]))
        assert np.array_equal(g["pred_masks"], np.asarray(w["pred_masks"]) > 0)
    got, want = tev.evaluate(), jev.evaluate()
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], rtol=1e-6, atol=1e-6)


def _detections(seed=0, n_img=3, hw=(16, 20)):
    """Seeded ground truth (with crowds and an unknown class 9) and detections that
    overlap it, with tied scores."""
    rs = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_img):
        g = rs.randint(1, 5)
        gm = np.zeros((g, *hw), np.uint8)
        for i in range(g):
            y, x = rs.randint(0, hw[0] - 5), rs.randint(0, hw[1] - 5)
            gm[i, y : y + rs.randint(3, 8), x : x + rs.randint(3, 8)] = 1
        gc = rs.choice([0, 1, 2, 9], g)
        gts.append({"masks": gm, "classes": gc, "iscrowd": (rs.rand(g) < 0.2).astype(np.int64)})
        p = rs.randint(1, 7)
        pm = np.roll(gm[rs.randint(0, g, p)], rs.randint(-1, 2), axis=-1).astype(np.float32)
        scores = np.round(rs.rand(p), 1).astype(np.float32)  # rounded: ties
        preds.append({"pred_masks": pm, "scores": scores, "pred_classes": rs.choice([0, 1, 2, 9], p)})
    return preds, gts


def test_mask_ap_and_open_world_ap_equal_rba_tpu():
    for seed in range(3):
        preds, gts = _detections(seed)
        assert tse.mask_average_precision(preds, gts, 10) == jse.mask_average_precision(preds, gts, 10)
        assert tse.open_world_ap(preds, gts, unknown_class=9) == jse.open_world_ap(preds, gts, unknown_class=9)


def _write_val_tree(root, n=2):
    frames = _frames(n, seed=1)
    img_dir, gt_dir = root / "leftImg8bit" / "val" / "cityA", root / "gtFine" / "val" / "cityA"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    for i, (image, label) in enumerate(frames):
        Image.fromarray(image).save(img_dir / f"f{i}_leftImg8bit.png")
        Image.fromarray(label.astype(np.uint8)).save(gt_dir / f"f{i}_gtFine_labelTrainIds.png")


def test_eval_semseg_cli_equals_rba_tpus(tmp_path, monkeypatch):
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.yaml").write_text(yaml.safe_dump(D2_TINY))
    _, model = d2_model_pair(jconfig.load_d2_config(str(model_dir / "config.yaml")),
                             tconfig.load_d2_config(str(model_dir / "config.yaml")), seed=5)
    save_params(str(model_dir / "params.npz"), model_to_jax_params(model))
    _write_val_tree(tmp_path / "cityscapes")
    args = ["--model-dir", str(model_dir), "--data-root", str(tmp_path / "cityscapes")]
    tcli.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu", "--precision", "fp32"])
    load = jsweep.load_model
    monkeypatch.setattr(jsweep, "load_model", lambda d: load(d, precision="fp32"))
    jcli.main(args + ["--out", str(tmp_path / "rba_tpu.json")])
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "rba_tpu"))
    assert got == want and np.isfinite(got["mIoU"])


def test_eval_semseg_defaults_to_the_gpu(tmp_path):
    args = ["--model-dir", str(tmp_path), "--data-root", str(tmp_path)]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="GPU"):
        tcli.main(args)
