"""The trainer's evaluation (``rba_tpu_torch/train/train_net.py`` ``run_val_eval``) against
rba_tpu's on the CPU, on the tiny COCO-mix config of ``tests/test_torch_train_cli.py``
loaded at fp32 in both packages:

- ``--eval-only`` from the latest checkpoint (with the TTA pass of TEST.AUG.ENABLED) and
  the in-train evaluations of ``--eval-period 2``: rba_tpu's ``run_val_eval`` on the same
  checkpoint, exactly on counts (so mIoU, fwIoU and pACC equal);
- a panoptic DATASETS.TEST (``coco_2017_val_panoptic_open``): PQ, mIoU and mask AP as
  rba_tpu's routing gives them;
- an evaluation inside a run leaves the training stream untouched: the losses of the steps
  after it and every parameter bit-equal to a run without it.
"""
import json

import numpy as np
import pytest
import yaml
from PIL import Image

from rba_tpu import config as jconfig
from rba_tpu.convert.checkpoint import load_checkpoint_params as jload_checkpoint_params
from rba_tpu.train import train_net as jtrain_net
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.train import train_net
from tests.test_torch_config_native import _write_coco_panoptic
from tests.test_torch_train_cli import _config, _write_trees
from tests.torch_port_common import catalogs_restored


@pytest.fixture(autouse=True)
def _restore_catalogs():
    with catalogs_restored():
        yield


def _fp32(pkg):
    load = pkg.load_d2_config
    return lambda path, **kw: load(path, **{"compute_dtype": "float32", **kw})


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' D2 loader at fp32, as the trainer reads its config through it."""
    monkeypatch.setattr(tconfig, "load_d2_config", _fp32(tconfig))
    monkeypatch.setattr(jconfig, "load_d2_config", _fp32(jconfig))


def _write_val(root, n=3, hw=(40, 72)):
    rs = np.random.RandomState(7)
    img_dir, gt_dir = root / "cityscapes" / "leftImg8bit" / "val" / "cityB", root / "cityscapes" / "gtFine" / "val" / "cityB"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rs.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(img_dir / f"v{i}_leftImg8bit.png")
        lab = np.repeat(np.repeat(rs.randint(0, 7, (hw[0] // 8, hw[1] // 8)), 8, 0), 8, 1).astype(np.uint8)
        lab[:4] = 255
        Image.fromarray(lab).save(gt_dir / f"v{i}_gtFine_labelTrainIds.png")


def _merge(d: dict, changes: dict) -> dict:
    for k, v in changes.items():
        d[k] = _merge(d.get(k, {}), v) if isinstance(v, dict) else v
    return d


def _setup(tmp_path, **yaml_changes):
    """The trees and the tiny config of tests/test_torch_train_cli.py, a val split, and
    ``yaml_changes`` merged into the config."""
    _write_trees(tmp_path)
    _write_val(tmp_path)
    path = _config(tmp_path / "config.yaml")
    path.write_text(yaml.safe_dump(_merge(yaml.safe_load(path.read_text()), yaml_changes)))
    return path


def _args(tmp_path, cfg_path, out):
    return ["--config-file", str(cfg_path), "--data-root", str(tmp_path / "cityscapes"), "--output-dir", str(out),
            "--log-period", "1", "--seed", "1", "--device", "cpu"]


def _rba_tpu_eval(cfg_path, step_dir, data_root, max_images=None, tta=False):
    jcfg = jconfig.load_d2_config(str(cfg_path))
    params = jload_checkpoint_params(str(step_dir), jcfg)
    return jtrain_net.run_val_eval(jcfg, params, str(data_root), max_images, tta=tta)


def _assert_eval_equal(got, want):
    """Counts exactly: mIoU, fwIoU and pACC are the same float64 arithmetic on them."""
    assert set(got) - {"step"} == set(want)
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)


def test_eval_only_equals_rba_tpus_run_val_eval(tmp_path, fp32):
    path = _setup(tmp_path, TEST={"AUG": {"ENABLED": True, "MIN_SIZES": [32], "MAX_SIZE": 200}})
    out = tmp_path / "out"
    train_net.main(_args(tmp_path, path, out) + ["--max-iter", "2", "--checkpoint-period", "2"])
    res = train_net.main(_args(tmp_path, path, out) + ["--eval-only"])
    assert res["step"] == 2 and res["eval_images"] == 3 and np.isfinite(res["mIoU"])
    want = _rba_tpu_eval(path, out / "checkpoints" / "step_2", tmp_path / "cityscapes")
    want_tta = _rba_tpu_eval(path, out / "checkpoints" / "step_2", tmp_path / "cityscapes", tta=True)
    want.update({f"{k}_TTA": v for k, v in want_tta.items() if k != "eval_images"})
    _assert_eval_equal(res, want)
    assert json.loads((out / "metrics.jsonl").read_text().splitlines()[-1]) == res


def test_in_train_eval_equals_rba_tpu_and_leaves_training_bit_equal(tmp_path, fp32):
    """--eval-period 2 over 4 steps: the evaluations at steps 2 and 4 (2 images each) equal
    rba_tpu's on the checkpoints of those steps; the losses of steps 3-4 and the final
    parameters equal a run with --eval-period 0 bit for bit."""
    path = _setup(tmp_path)
    runs = {}
    for name, period in (("eval", "2"), ("plain", "0")):
        out = tmp_path / name
        state = train_net.main(_args(tmp_path, path, out) + [
            "--max-iter", "4", "--checkpoint-period", "2", "--eval-period", period, "--eval-max-images", "2"])
        runs[name] = (state, [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()])
    (state_e, lines_e), (state_p, lines_p) = runs["eval"], runs["plain"]
    evals = [m for m in lines_e if "mIoU" in m]
    assert [m["step"] for m in evals] == [2, 4] and all(m["eval_images"] == 2 for m in evals)
    assert [m for m in lines_e if "mIoU" not in m] == [
        {**m, "imgs_per_sec": n["imgs_per_sec"]} for m, n in zip(lines_p, [m for m in lines_e if "mIoU" not in m])]
    for (name, p), q in zip(state_e.model.named_parameters(), state_p.model.parameters()):
        assert p.equal(q), name
    assert state_e.gen.get_state().equal(state_p.gen.get_state())
    assert not state_e.model.training  # the model's mode is put back
    for m in evals:
        want = _rba_tpu_eval(path, tmp_path / "eval" / "checkpoints" / f"step_{m['step']}", tmp_path / "cityscapes", 2)
        _assert_eval_equal(m, want)


def test_panoptic_val_split_equals_rba_tpu(tmp_path, fp32):
    """DATASETS.TEST coco_2017_val_panoptic_open under the datasets directory: PQ (with
    the open branch), mIoU and mask AP over the same images, as rba_tpu routes them."""
    path = _setup(tmp_path, DATASETS={"TEST": ["coco_2017_val_panoptic_open"]},
                  MODEL={"MASK_FORMER": {"TEST": {"PANOPTIC_ON": True, "SEMANTIC_ON": True, "INSTANCE_ON": True,
                                                  "OBJECT_MASK_THRESHOLD": 0.05, "OVERLAP_THRESHOLD": 0.3}}})
    _write_coco_panoptic(tmp_path)
    out = tmp_path / "out"
    train_net.main(_args(tmp_path, path, out) + ["--max-iter", "1"])
    res = train_net.main(_args(tmp_path, path, out) + ["--eval-only"])
    want = _rba_tpu_eval(path, out / "checkpoints" / "step_1", tmp_path / "cityscapes")
    assert {"All_pq", "Unknown_pq", "mIoU", "instance_AP"} <= set(res) and res["eval_images"] == 3
    assert set(res) - {"step"} == set(want)
    np.testing.assert_allclose([res[k] for k in want], [want[k] for k in want], rtol=1e-6, atol=1e-6)
    assert all(res[k] == want[k] for k in want if not k.startswith("instance_"))  # PQ and mIoU exactly


def test_missing_val_data_raises(tmp_path, fp32):
    _write_trees(tmp_path)
    path = _config(tmp_path / "config.yaml")
    with pytest.raises(FileNotFoundError, match="no val data"):
        train_net.main(_args(tmp_path, path, tmp_path / "out") + ["--eval-only"])
