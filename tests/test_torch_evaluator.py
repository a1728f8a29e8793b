"""The port's OODEvaluator against rba_tpu's on the CPU, at the tiny config in fp32.

Both packages hold the same weights (``model_pair``) and read the same seeded
synthetic images.  Bounds: score maps within ``SCORE_TOL``; the Gaussian blur on
equal inputs within ``BLUR_TOL``; metrics within ``METRIC_TOL``.  Inside the port,
cohorts and the model-fused sweep must give exactly the metrics of the plain
streaming loop.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rba_tpu import config as jconfig
from rba_tpu.data.ood_datasets import SyntheticAnomaly as JSynthetic
from rba_tpu.evalx import evaluator as jev
from rba_tpu.models import maskformer as jmf
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.data.ood_datasets import SyntheticAnomaly
from rba_tpu_torch.evalx import evaluator as tev
from rba_tpu_torch.evalx.metrics import StreamingOODMetrics
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.ops.quant import is_quantized
from tests.torch_port_common import max_abs, model_pair, t

SCORE_TOL = 1e-4
BLUR_TOL = 1e-5
METRIC_TOL = 1e-4
HW = (64, 96)


@pytest.fixture(scope="module")
def pair():
    """(rba_tpu evaluator factory, port evaluator factory) on the same weights."""
    params, model = model_pair(jconfig.tiny_test_config(), tconfig.tiny_test_config(), seed=0)

    def jax_ev(**kw):
        return jev.OODEvaluator(jconfig.tiny_test_config(), params, **kw)

    def port_ev(**kw):
        return tev.OODEvaluator(tconfig.tiny_test_config(), model, **kw)

    return jax_ev, port_ev


def _fallback_warned(caught) -> bool:
    return any("re-running the exact all-pixel path" in str(w.message) for w in caught)


@pytest.mark.parametrize("score, smoothing", [("rba", False), ("rba", True), ("energy", False)])
def test_scores_match(pair, score, smoothing):
    jax_ev, port_ev = pair
    want, want_gt = jax_ev(score=score, use_gaussian_smoothing=smoothing).compute_anomaly_scores(
        JSynthetic(n=2, hw=HW))
    got, got_gt = port_ev(score=score, use_gaussian_smoothing=smoothing).compute_anomaly_scores(
        SyntheticAnomaly(n=2, hw=HW))
    assert got.shape == (2, *HW) and got.dtype == np.float32
    np.testing.assert_array_equal(got_gt, want_gt)
    assert max_abs(got, want) <= SCORE_TOL


def test_preds_match(pair):
    jax_ev, port_ev = pair
    _, _, want = jax_ev().compute_anomaly_scores(JSynthetic(n=1, hw=HW), return_preds=True)
    _, _, got = port_ev().compute_anomaly_scores(SyntheticAnomaly(n=1, hw=HW), return_preds=True)
    assert got.shape == (1, *HW)
    assert (got == want).mean() >= 0.999  # argmax ties at fp32 rounding may flip a pixel


def test_gaussian_blur_matches(rng):
    x = rng.randn(2, 20, 30).astype(np.float32)
    assert max_abs(tev._gaussian_blur(t(x)), jev._gaussian_blur(jnp.asarray(x))) <= BLUR_TOL


def test_energy_score_matches(rng):
    sem = (rng.randn(2, 7, 12, 20) * 3).astype(np.float32)
    for temperature in (1.0, 0.5):
        assert max_abs(tmf.energy_score(t(sem), temperature), jmf.energy_score(jnp.asarray(sem), temperature)) <= 1e-5


@pytest.mark.parametrize("score_range, falls_back", [
    (None, True),  # these scores sit in a band of ~4: 2^22 bins over 128 do not certify them
    ((-8.0, 8.0), False),  # 8x finer bins: certified
    ((-1.0, -0.5), True),  # clipped
], ids=["default", "finer", "clipped"])
def test_evaluate_dataset_matches_and_takes_the_same_route(pair, score_range, falls_back):
    """Cohorts of 1 and 3 give equal metrics in the port, both packages warn and fall
    back to the exact path on the same inputs or both do not, and their metrics agree."""
    jax_ev, port_ev = pair
    routes, results = {}, {}
    for name, ev, ds, cohort in (("jax", jax_ev(), JSynthetic(n=4, hw=HW), 1),
                                 ("port", port_ev(), SyntheticAnomaly(n=4, hw=HW), 1),
                                 ("port3", port_ev(), SyntheticAnomaly(n=4, hw=HW), 3)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results[name] = ev.evaluate_dataset(ds, score_range=score_range, cohort=cohort)
        routes[name] = _fallback_warned(caught)
    assert routes == {"jax": falls_back, "port": falls_back, "port3": falls_back}
    assert results["port3"] == results["port"]
    for k, v in results["jax"].items():
        assert abs(results["port"][k] - v) <= METRIC_TOL, (k, results["port"][k], v)


def test_cohort_histograms_equal_one_image_at_a_time(pair):
    _, port_ev = pair
    ev = port_ev()
    ds = SyntheticAnomaly(n=3, hw=HW)
    one = StreamingOODMetrics(device="cpu")
    for sample in ds:
        one.update(ev.score_fn(sample.image[None])[0], sample.label.astype(np.uint8))
    fn = tev.make_cohort_fn(ev.cfg, ev.model, "rba", False, one.bins, one.range, "linear")
    packed = np.stack([np.concatenate([s.image, s.label.astype(np.uint8)[..., None]], -1) for s in ds])
    dp, dn, lo, hi = fn(packed)
    assert torch.equal(dp, one.pos) and torch.equal(dn, one.neg)
    assert float(lo) == float(one.smin) and float(hi) == float(one.smax)


def test_bootstrapped_matches(pair):
    jax_ev, port_ev = pair
    want = jax_ev().evaluate_ood_bootstrapped(JSynthetic(n=4, hw=HW), ratio=0.5, trials=3)
    got = port_ev().evaluate_ood_bootstrapped(SyntheticAnomaly(n=4, hw=HW), ratio=0.5, trials=3)
    for g, w in zip(got, want):  # means and stds, in percent
        assert sorted(g) == sorted(w) == ["aupr", "auroc", "fpr95"]
        for k in w:
            assert abs(g[k] - w[k]) <= 100 * METRIC_TOL, (k, g[k], w[k])


def test_evaluate_dataset_multi_equals_one_model_at_a_time(pair):
    _, port_ev = pair
    evs = {"rba": port_ev(), "energy": port_ev(score="energy")}
    ds = SyntheticAnomaly(n=2, hw=HW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fused = tev.evaluate_dataset_multi(evs, ds)
        single = {name: ev.evaluate_dataset(ds) for name, ev in evs.items()}
    assert fused == single


def test_unported_scores_and_options_raise(pair):
    """A score the model cannot give raises; int8 weights, refused until §A.8 ported them,
    score an int8 copy of the model as rba_tpu's evaluator scores its int8 tree."""
    jax_ev, port_ev = pair
    # a model without the DenseHybrid head has no ood_pred to score
    with pytest.raises(ValueError, match="ood_pred"):
        port_ev(score="dense_hybrid").compute_anomaly_scores(SyntheticAnomaly(n=1, hw=HW))
    model = port_ev().model
    ev = tev.OODEvaluator(dataclasses.replace(tconfig.tiny_test_config(), weight_quant="int8"), model)
    assert is_quantized(ev.model) and not is_quantized(model)
    want, _ = jev.OODEvaluator(dataclasses.replace(jconfig.tiny_test_config(), weight_quant="int8"),
                               jax_ev().params).compute_anomaly_scores(JSynthetic(n=1, hw=HW))
    got, _ = ev.compute_anomaly_scores(SyntheticAnomaly(n=1, hw=HW))
    assert max_abs(got, want) <= SCORE_TOL


def test_miou_matches(rng):
    gt = rng.choice([0, 1, 2, 3, 255], (40, 50))
    pred = rng.choice([0, 1, 2, 3], (40, 50))
    assert tev.miou(pred, gt, num_classes=5) == jev.miou(pred, gt, num_classes=5)
