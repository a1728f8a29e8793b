"""Data parallelism of the port on the CPU: two gloo ranks (spawned once for the file,
``tests/torch_parallel_ranks.py``) against the port's 1-rank step on the same global
batch, which tests/test_torch_train_step.py holds against rba_tpu:

- 2 steps, with and without ``grad_accum=2``: every loss of both steps within 1e-5
  (relative to the loss, floored at 1), the first step's gradients within 1e-5 of each
  leaf's largest element, the ranks' parameters equal bit for bit, and the all-reduces
  counted per step (one per supervised loss term and one for ``num_masks`` per
  micro-batch, one per gradient bucket per step);
- the same for the criterion's other batch sums (``VARIANTS``: the smoothness, sparsity
  and gambler losses; DenseHybrid's loss with its detached global mean; the outlier
  loss's binary cross-entropy; the per-pixel head's CE at PointRend's points);
- the sharded OOD evaluation of 3 images over 2 ranks (the tail padded): histograms equal
  to a 1-rank loop's exactly, and the metrics;
- the trainer: ``train_net --num-gpus 2 --device cpu`` through its launcher writes every
  step's losses and gradient norm of ``--num-gpus 1`` within 1e-5, at fp32.  (At the
  Detectron2 config's bf16 compute the ranks' forwards of 1 image round otherwise than one
  forward of 2, by a bf16 ulp, which moves the gradients by up to half a percent.)

The sums run in another order than in one process, so nothing here is bit for bit but the
histograms and the ranks' agreement.  AdamW's first update is near lr·sign(g), so the
updated parameters are not compared with the 1-rank run's."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rba_tpu_torch.evalx.metrics import histogram_update, metrics_from_histograms
from rba_tpu_torch.models.maskformer import build_model, maskformer_infer_rba
from rba_tpu_torch.parallel import mesh as pmesh
from rba_tpu_torch.train.train_step import grad_buckets
from tests.torch_parallel_ranks import VARIANTS, dp_rank, run_ranks, train_batch, train_cfg, train_run, variant_cfg

ROOT = Path(__file__).resolve().parent.parent
WORLD, B, ACCUMS = 2, 4, (1, 2)
EVAL_IMAGES, EVAL_HW, BINS = 3, (32, 48), 1 << 12
LOSS_TOL = GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = train_cfg()
    batches = [train_batch(0, B), train_batch(1, B)]
    ranks = run_ranks(dp_rank, WORLD, tmp_path_factory.mktemp("dp"),
                      args=(cfg, batches, ACCUMS, (cfg, EVAL_IMAGES, EVAL_HW, BINS)))
    one = {accum: train_run(cfg, batches, accum) for accum in ACCUMS}
    one.update({name: train_run(variant_cfg(name), batches, 1) for name in VARIANTS})
    return cfg, ranks, one


def _losses_match(ranks, one, key, names=()):
    want = one[key][0]
    for rank in ranks:
        got = rank[key][0]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and set(names) <= w.keys()
            for k in w:
                assert abs(g[k] - w[k]) <= LOSS_TOL * max(1.0, abs(w[k])), (k, g[k], w[k])


def _gradients_match(ranks, one, key):
    want = one[key][1]
    for rank in ranks:
        got = rank[key][1]
        assert got.keys() == want.keys()
        for n, w in want.items():
            assert np.abs(got[n] - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-30), n


@pytest.mark.parametrize("accum", ACCUMS)
def test_losses_match_one_rank(runs, accum):
    _, ranks, one = runs
    _losses_match(ranks, one, accum)


@pytest.mark.parametrize("accum", ACCUMS)
def test_gradients_match_one_rank(runs, accum):
    _, ranks, one = runs
    _gradients_match(ranks, one, accum)


VARIANT_LOSSES = {"smooth_sparse_gambler": ("smoothness_loss", "sparsity_loss", "gambler_loss", "smoothness_loss_0"),
                  "densehybrid": ("densehybrid_loss",), "bce": ("outlier_loss", "outlier_loss_0"),
                  "per_pixel": ("loss_sem_seg",)}


@pytest.mark.parametrize("name", VARIANTS)
def test_other_batch_sums_match_one_rank(runs, name):
    """Both steps' losses (the variant's own terms among them) and the first step's
    gradients within 1e-5 of the 1-rank step's, and the ranks' parameters equal."""
    _, (r0, r1), one = runs
    _losses_match((r0, r1), one, name, VARIANT_LOSSES[name])
    _gradients_match((r0, r1), one, name)
    for n, p in r0[name][2].items():
        assert np.array_equal(p, r1[name][2][n]), n


@pytest.mark.parametrize("accum", ACCUMS)
def test_ranks_stay_equal(runs, accum):
    _, (r0, r1), _ = runs
    assert r0[accum][2].keys() == r1[accum][2].keys()
    for n, p in r0[accum][2].items():
        assert np.array_equal(p, r1[accum][2][n]), n


@pytest.mark.parametrize("accum", ACCUMS)
def test_all_reduces_counted(runs, accum):
    cfg, ranks, _ = runs
    layers = cfg.decoder.dec_layers + 1  # deep supervision: the final layer and each aux
    terms = 2 + cfg.ood.outlier_supervision  # ce, masks (mask and dice in one), outlier
    buckets = len(grad_buckets(list(build_model(cfg, device="cpu").parameters())))
    for rank in ranks:
        counts = rank[accum][3]
        assert counts == {"loss": 2 * accum * (1 + layers * terms), "grad": 2 * buckets, "model": 0}


def test_sharded_eval_equals_one_rank(runs):
    from rba_tpu_torch.data.ood_datasets import SyntheticAnomaly

    cfg, ranks, _ = runs
    model = build_model(cfg, device="cpu", seed=1)
    pos = np.zeros(BINS, np.int64)
    neg = np.zeros(BINS, np.int64)
    with torch.inference_mode():
        for s in SyntheticAnomaly(n=EVAL_IMAGES, hw=EVAL_HW):
            score = maskformer_infer_rba(model, cfg, torch.from_numpy(s.image[None]).float())
            p, n = histogram_update(score[0], torch.from_numpy(s.label), bins=BINS)
            pos += p.numpy()
            neg += n.numpy()
    assert neg.sum() > 0 and pos.sum() > 0
    m = metrics_from_histograms(pos, neg)
    for rank in ranks:
        got_pos, got_neg, metrics = rank["hist"]
        assert np.array_equal(got_pos, pos) and np.array_equal(got_neg, neg)
        assert metrics == {"auroc": m["AUROC"], "aupr": m["AUPRC"], "fpr95": m["FPR@95TPR"]}


def test_data_rows_split_each_micro_batch():
    assert pmesh.data_rows(8, 1, 2) == [4, 5, 6, 7]
    assert pmesh.data_rows(8, 1, 2, micro=2) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        pmesh.data_rows(6, 0, 2, micro=2)


def test_trainer_num_gpus_2_matches_one_gpu(tmp_path):
    import dataclasses

    from rba_tpu_torch.config import load_config, save_config
    from rba_tpu_torch.train import train_net
    from tests.test_torch_train_cli import _config, _write_trees

    _write_trees(tmp_path)
    # the Detectron2 recipe at fp32, in the port's own YAML
    cfg = dataclasses.replace(load_config(str(_config(tmp_path / "d2.yaml"))), compute_dtype="float32")
    save_config(str(tmp_path / "config.yaml"), cfg)
    args = ["--config-file", str(tmp_path / "config.yaml"), "--data-root", str(tmp_path / "cityscapes"),
            "--device", "cpu", "--max-iter", "2", "--log-period", "1", "--seed", "1", "--workers", "1"]
    one = tmp_path / "one"
    train_net.main(args + ["--output-dir", str(one)])
    two = tmp_path / "two"
    subprocess.run([sys.executable, "-m", "rba_tpu_torch.train.train_net", *args, "--output-dir", str(two),
                    "--num-gpus", "2"], cwd=ROOT, check=True, timeout=120,
                   env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    want = [json.loads(line) for line in open(one / "metrics.jsonl")]
    got = [json.loads(line) for line in open(two / "metrics.jsonl")]
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["ood_images"] == w["ood_images"]
        for k, v in w.items():
            if k not in ("step", "imgs_per_sec"):
                assert abs(g[k] - v) <= LOSS_TOL * max(1.0, abs(v)), (g["step"], k, g[k], v)
    assert (two / "checkpoints" / "step_2" / "params.npz").exists()
