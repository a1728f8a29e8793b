"""The DenseHybrid ``ood_pred`` head and the ``dense_hybrid`` score of the port against
rba_tpu's on the CPU at fp32.

``tiny_test_config`` with ``ood_prediction=True`` and seeded weights
(``d2_model_pair``: the head's batch norm has non-trivial running statistics).
Bounds: ``HEAD_TOL`` on the head's logits (a BN, a ReLU and a 1×1 conv in fp32);
``SCORE_TOL`` on the score, whose log-sum-exp and log terms add to the fp32 forward's
difference; the sweep's metrics within ``METRIC_TOL`` of rba_tpu's sweep, as in
tests/test_torch_sweep.py.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rba_tpu import config as jconfig
from rba_tpu.convert.checkpoint import save_params
from rba_tpu.evalx import evaluator as jev
from rba_tpu.evalx import sweep as jsweep
from rba_tpu.models import maskformer as jmf
from rba_tpu.models import transformer_decoder as jtd
from rba_tpu.tools.selfcheck import build_synthetic_dataset_trees
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.evalx import evaluator as tev
from rba_tpu_torch.evalx import sweep as tsweep
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import transformer_decoder as ttd
from rba_tpu_torch.ops.resize import resize_bilinear
from tests.torch_port_common import D2_TINY, d2_model_pair, max_abs, t

HEAD_TOL = 1e-5
SCORE_TOL = 1e-4
METRIC_TOL = 1e-4


def _with_head(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, ood_prediction=True))


JCFG, TCFG = _with_head(jconfig.tiny_test_config()), _with_head(tconfig.tiny_test_config())


@pytest.fixture(scope="module")
def tiny():
    return d2_model_pair(JCFG, TCFG, seed=3)


def test_ood_pred_head_matches_rba_tpu(tiny, rng):
    params, model = tiny
    feats = rng.randn(2, 8, 12, 64).astype(np.float32)
    mf = rng.randn(2, 16, 24, 64).astype(np.float32)
    want = jax.jit(lambda p, x, m: jtd.decoder_apply(p, JCFG.decoder, [x], m, need_aux=False))(
        params["sem_seg_head"]["predictor"], jnp.asarray(feats), jnp.asarray(mf))
    with torch.no_grad():
        got = ttd.decoder_apply(model.sem_seg_head["predictor"], TCFG.decoder, [t(feats)], t(mf))
    assert got["ood_pred"].shape == (2, 2, 16, 24)
    assert max_abs(got["ood_pred"], want["ood_pred"]) < HEAD_TOL
    # a model without the head returns no ood_pred
    plain = tmf.build_model(tconfig.tiny_test_config(), device="cpu")
    with torch.no_grad():
        assert "ood_pred" not in ttd.decoder_apply(plain.sem_seg_head["predictor"],
                                                   tconfig.tiny_test_config().decoder, [t(feats)], t(mf))


def test_maskformer_infer_ood_pred_resized_with_align_corners(tiny, rng):
    params, model = tiny
    img = (rng.rand(1, 45, 61, 3) * 255).astype(np.float32)  # padded to 64x64: stride 4 is 16x16
    want = jax.jit(lambda p, x: jmf.maskformer_infer(p, JCFG, x))(params, jnp.asarray(img))
    got = tmf.maskformer_infer(model, TCFG, t(img))
    assert got["ood_pred"].shape == (1, 2, 45, 61)
    assert max_abs(got["ood_pred"], want["ood_pred"]) < HEAD_TOL
    # the head's stride-4 logits, resized to the image with align_corners=True (not False)
    x = tmf.preprocess(TCFG, t(img))
    with torch.no_grad():
        low = tmf.maskformer_forward(model, TCFG, x)["ood_pred"]
    assert torch.equal(got["ood_pred"], resize_bilinear(low, (45, 61), align_corners=True))
    assert max_abs(got["ood_pred"], resize_bilinear(low, (45, 61), align_corners=False)) > 1e-3


def test_dense_hybrid_score_matches_rba_tpu(tiny, rng):
    params, model = tiny
    img = (rng.rand(1, 40, 52, 3) * 255).astype(np.uint8)
    want = jev.make_score_fn(JCFG, params, "dense_hybrid")(img)
    got = tev.make_score_fn(TCFG, model, "dense_hybrid")(img)
    assert got.shape == (1, 40, 52) and bool(torch.isfinite(got).all())
    assert max_abs(got, want) < SCORE_TOL
    # the score is -logsumexp(sem_seg) + log(softmax(ood_pred)[:, 1] + 1e-9)
    out = tmf.maskformer_infer(model, TCFG, torch.as_tensor(img).float())
    p = torch.softmax(out["ood_pred"], 1)[:, 1]
    assert torch.equal(got, -torch.logsumexp(out["sem_seg"], 1) + torch.log(p + 1e-9))


def test_dense_hybrid_without_the_head_raises():
    model = tmf.build_model(tconfig.tiny_test_config(), device="cpu")
    with pytest.raises(ValueError, match="ood_pred"):
        tev.make_score_fn(tconfig.tiny_test_config(), model, "dense_hybrid")(np.zeros((1, 32, 32, 3), np.uint8))


def test_sweep_dense_hybrid_matches_rba_tpu(tmp_path):
    """A zoo whose config sets DENSE_HYBRID_LOSS, at fp32, through the streaming path
    (asinh histograms, with the exact fall-back where they do not certify)."""
    d2 = json.loads(json.dumps(D2_TINY))
    d2["MODEL"]["MASK_FORMER"]["DENSE_HYBRID_LOSS"] = True
    model_dir = tmp_path / "models" / "dh"
    model_dir.mkdir(parents=True)
    (model_dir / "config.yaml").write_text(yaml.safe_dump(d2))
    jcfg, tcfg = (pkg.load_d2_config(str(model_dir / "config.yaml")) for pkg in (jconfig, tconfig))
    assert jcfg.decoder.ood_prediction and tcfg.decoder.ood_prediction
    save_params(str(model_dir / "params.npz"), d2_model_pair(jcfg, tcfg, seed=4)[0])
    build_synthetic_dataset_trees(str(tmp_path / "datasets"), hw=(48, 64), n=2)
    args = ["--models_folder", str(tmp_path / "models"), "--datasets_folder", str(tmp_path / "datasets"),
            "--dataset_mode", "road_anomaly", "--precision", "fp32", "--score_func", "dense_hybrid"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random weights: the histograms may not certify
        jsweep.main(args + ["--out_path", str(tmp_path / "jax")])
        tsweep.main(args + ["--out_path", str(tmp_path / "torch"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "dh" / "results.json").read_text())
    got = json.loads((tmp_path / "torch" / "dh" / "results.json").read_text())
    assert sorted(got) == sorted(want) == ["road_anomaly"]
    for k, v in want["road_anomaly"].items():
        assert np.isfinite(got["road_anomaly"][k]) and abs(got["road_anomaly"][k] - v) <= METRIC_TOL, (k, v)
