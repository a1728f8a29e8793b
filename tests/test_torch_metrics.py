"""The port's OOD metrics against rba_tpu's on the CPU.

- ``histogram_update``: in linear mode the same bin for every pixel, so equal counts
  bin for bin.  With ``transform="asinh"`` torch's and XLA's asinh may differ by an
  ulp or two, which can move a pixel to the next bin: moves of one bin only, on at
  most ``ASINH_MOVED_SHARE`` of the pixels.
- ``metrics_from_histograms`` and ``StreamingOODMetrics`` run the same numpy on equal
  counts: equal results.  ``exact_ood_metrics`` of rba_tpu may take its native
  radix-sort engine; the port's numpy agrees with whatever it returns within 1e-9,
  except where scores hold both -0.0 and 0.0, which that engine ranks apart: there
  the port is held against sklearn.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.evalx import metrics as jm
from rba_tpu_torch.evalx import metrics as tm
from tests.torch_port_common import record

ASINH_MOVED_SHARE = 0.01
EXACT_TOL = 1e-9


def _scores_labels(rng, n=50_000):
    """Scores over many magnitudes, some beyond the default range, and labels with
    ignored pixels."""
    s = rng.randn(n) * rng.choice([1e-3, 1.0, 30.0, 1e5], n)
    s[:20] = [np.inf, -np.inf, 64.0, -64.0, 63.99999, 1e30, -1e30, 0.0, -0.0, 1e-30] * 2
    return s.astype(np.float32), rng.choice([0, 1, 255], n, p=[0.7, 0.2, 0.1]).astype(np.uint8)


def _jax_bins(s, bins, score_range, transform):
    lo, hi = score_range
    x = jnp.arcsinh(jnp.asarray(s)) if transform == "asinh" else jnp.asarray(s)
    return np.asarray(jnp.clip(((jnp.clip(x, lo, hi) - lo) * (bins / (hi - lo))).astype(jnp.int32), 0, bins - 1))


@pytest.mark.parametrize("transform, bins, score_range", [
    ("linear", tm.DEFAULT_BINS, tm.DEFAULT_RANGE),
    ("linear", 1000, (-1.3, 2.7)),  # a scale that float32 does not hold exactly
    ("asinh", tm.ASINH_BINS, tm.ASINH_RANGE),
])
def test_histogram_update_matches(rng, request, transform, bins, score_range):
    s, lab = _scores_labels(rng)
    jp, jn = jm.histogram_update(jnp.asarray(s), jnp.asarray(lab), bins=bins, score_range=score_range,
                                 transform=transform)
    tp, tn = tm.histogram_update(torch.from_numpy(s), torch.from_numpy(lab), bins=bins, score_range=score_range,
                                 transform=transform)
    assert tp.dtype == tn.dtype == torch.int64 and tp.shape == (bins,)
    assert int(tp.sum()) == int((lab == 1).sum()) and int(tn.sum()) == int((lab == 0).sum())
    if transform == "linear":
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    moved = tm._bin_index(torch.from_numpy(s), bins, score_range, transform).numpy() - _jax_bins(
        s, bins, score_range, transform)
    assert np.abs(moved).max() <= (0 if transform == "linear" else 1)
    assert (moved != 0).mean() <= ASINH_MOVED_SHARE
    record(request, moved_share=(moved != 0).mean())


def _histograms(rng, bins=4096, empty_share=0.6):
    pos = rng.poisson(0.5, bins) * (rng.rand(bins) > empty_share)
    neg = rng.poisson(3.0, bins) * (rng.rand(bins) > empty_share)
    return pos.astype(np.int64), neg.astype(np.int64)


@pytest.mark.parametrize("with_bounds", [False, True])
def test_metrics_from_histograms_match(rng, with_bounds):
    cases = [_histograms(rng), _histograms(rng, bins=64, empty_share=0.0),
             (np.zeros(16, np.int64), np.arange(16))]  # no positives: NaN
    for pos, neg in cases:
        want = jm.metrics_from_histograms(pos, neg, with_bounds=with_bounds)
        got = tm.metrics_from_histograms(pos, neg, with_bounds=with_bounds)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal([got[k] for k in sorted(got)], [want[k] for k in sorted(want)])


@pytest.mark.parametrize("case", ["random", "ties", "all_ignored", "one_class"])
def test_exact_ood_metrics_match(rng, case):
    s = rng.randn(20_000).astype(np.float32)
    lab = rng.choice([0, 1, 255], 20_000, p=[0.7, 0.2, 0.1]).astype(np.uint8)
    if case == "ties":
        s = np.round(s * 4) / 4 + 0.0  # about 30 distinct scores; + 0.0 turns -0.0 into 0.0
    elif case == "all_ignored":
        lab[:] = 255
    elif case == "one_class":
        lab[lab == 1] = 0
    want = jm.exact_ood_metrics(s, lab)
    got = tm.exact_ood_metrics(s, lab)
    assert sorted(got) == sorted(want) == ["AUPRC", "AUROC", "FPR@95TPR"]
    for k in want:
        if case in ("all_ignored", "one_class"):
            assert np.isnan(got[k]) and np.isnan(want[k])
        else:
            assert abs(got[k] - want[k]) <= EXACT_TOL, (k, got[k], want[k])


def test_exact_ood_metrics_ties_signed_zeros_as_sklearn(rng):
    """-0.0 and 0.0 are one score, as sklearn ranks them.  (rba_tpu's native engine
    keys scores by their bits and splits the two, so on such input it is not the
    reference here.)"""
    from sklearn.metrics import average_precision_score, roc_auc_score

    s = np.round(rng.randn(20_000).astype(np.float32) * 4) / 4  # holds both -0.0 and 0.0
    assert np.signbit(s[s == 0]).any() and not np.signbit(s[s == 0]).all()
    lab = rng.choice([0, 1, 255], 20_000, p=[0.7, 0.2, 0.1]).astype(np.uint8)
    keep = lab != 255
    got = tm.exact_ood_metrics(s, lab)
    assert abs(got["AUPRC"] - average_precision_score(lab[keep] == 1, s[keep])) <= EXACT_TOL
    assert abs(got["AUROC"] - roc_auc_score(lab[keep] == 1, s[keep])) <= EXACT_TOL


def _stream(pkg, images, score_range=None, transform="linear", **kw):
    """Run ``images`` through one package's StreamingOODMetrics; returns what its
    public surface reports and the warnings it gave."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if pkg is tm:
            m = tm.StreamingOODMetrics(score_range=score_range, transform=transform, device="cpu", **kw)
            for s, lab in images:
                m.update(torch.from_numpy(s), lab)
        else:
            m = jm.StreamingOODMetrics(score_range=score_range, transform=transform, **kw)
            for s, lab in images:
                m.update(jnp.asarray(s), lab)
        out = dict(clipped=m.clipped, certified=m.certified(), certified_loose=m.certified(tol=1.0),
                   metrics=m.compute(), smin=float(m.smin), smax=float(m.smax))
        out["qerr"] = m.quantization_error(out["metrics"])
    out["warnings"] = sorted(str(w.message) for w in caught)
    return out


@pytest.mark.parametrize("score_range, transform, bins", [
    (None, "linear", None),  # default range: within it
    ((-0.5, 0.5), "linear", None),  # clipped
    ((-4.0, 4.0), "linear", 1 << 12),  # coarse: certified error above tolerance
    (None, "asinh", 1 << 16),
])
def test_streaming_matches(rng, score_range, transform, bins):
    images = []
    for _ in range(3):
        lab = rng.choice([0, 1, 255], (24, 40), p=[0.7, 0.2, 0.1]).astype(np.uint8)
        images.append(((rng.randn(24, 40) + 1.5 * (lab == 1)).astype(np.float32), lab))
    got = _stream(tm, images, score_range, transform, bins=bins)
    want = _stream(jm, images, score_range, transform, bins=bins)
    assert got == want


def test_absorb_equals_update(rng):
    s, lab = _scores_labels(rng, n=4000)
    s = np.clip(s, -60, 60)
    a = tm.StreamingOODMetrics(device="cpu")
    b = tm.StreamingOODMetrics(device="cpu")
    for part in np.array_split(np.arange(s.size), 3):
        a.update(torch.from_numpy(s[part]), lab[part])
        dp, dn = tm.histogram_update(torch.from_numpy(s[part]), torch.from_numpy(lab[part]))
        lo, hi = tm._scored_range(torch.from_numpy(s[part]), torch.from_numpy(lab[part]))
        b.absorb(dp, dn, lo, hi, part.size)
    assert torch.equal(a.counts, b.counts)
    assert float(a.smin) == float(b.smin) == float(s[lab != 255].min())
    assert float(a.smax) == float(b.smax) == float(s[lab != 255].max())
    assert a.compute() == b.compute()


def test_unknown_transform_raises():
    with pytest.raises(ValueError, match="transform"):
        tm.StreamingOODMetrics(transform="log", device="cpu")
