"""The frozen reference against the port at small sizes on the CPU, at fp32: every
configuration file of the benchmark (Swin-B and ResNet-50, and a backbone that a
configuration brings in its own file) at its full widths, the one- and three-level
MSDeformAttn encoders, the masked decoder and the RbA score; the exact OOD metrics against
a brute-force count."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import inputs, system
from benchmark.reference import model as ref
from benchmark.reference.ood_metrics import ood_metrics

from .tiny import CONFIG_NAMES, repo_config

SCENE = {"stripes": 2, "inliers": 3, "anomalies": 1}


def _model(name: str, compute_dtype: str):
    """(the configuration's ``model`` at ``compute_dtype``, its reference backbone file or None)."""
    config, backbone = repo_config(name)
    return dict(config["model"], compute_dtype=compute_dtype), backbone


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_reference_equals_port_at_fp32(name):
    model, backbone = _model(name, "float32")
    weights = inputs.make_weights(system.parameter_shapes(model), model, 3, "cpu")
    cfg, net = system.build(model, {k: v.clone() for k, v in weights.items()})
    frames, _ = next(inputs.make_scenes(2, 64, 96, SCENE, 3, "cpu"))
    got = system.serve_fn(cfg, net, "fused")(frames)
    want = torch.stack([ref.score_map(weights, model, f, backbone=backbone) for f in frames])
    assert got.shape == want.shape == (2, 64, 96)
    assert float(want.std()) > 0.1  # the maps are not flat
    # fp32 rounding in other orders, which the random ResNet's growing activations amplify
    # to about 1e-3 of a score that lies near -16 (seed 3: 1.34e-3 at most, 3.1e-4 mean)
    gap = (got - want).abs()
    assert float(gap.max()) < 5e-3 and float(gap.mean()) < 1e-3


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_control_is_farther_than_the_bf16_program(name):
    """The reference's control (fp8 backbone, TF32 elsewhere) lies farther from the fp32
    reference than the program at its stated bf16 backbone, on the mean gap."""
    model, backbone = _model(name, "bfloat16")
    weights = inputs.make_weights(system.parameter_shapes(model), model, 4, "cpu")
    cfg, net = system.build(model, {k: v.clone() for k, v in weights.items()})
    frames, _ = next(inputs.make_scenes(2, 64, 96, SCENE, 4, "cpu"))
    got = system.serve_fn(cfg, net, "fused")(frames)
    want = torch.stack([ref.score_map(weights, model, f, backbone=backbone) for f in frames])
    control = torch.stack([ref.score_map(weights, model, f, lowp=True, backbone=backbone) for f in frames])
    assert float((control - want).abs().mean()) > 3 * float((got - want).abs().mean())


def _brute_force(scores: np.ndarray, labels: np.ndarray):
    s, y = scores[labels != 255].astype(np.float64), labels[labels != 255] == 1
    pos, neg = s[y], s[~y]
    auroc = ((pos[:, None] > neg[None, :]).sum() + 0.5 * (pos[:, None] == neg[None, :]).sum()) / (len(pos) * len(neg))
    thresholds = np.unique(s)[::-1]
    tp = np.array([(pos >= t).sum() for t in thresholds], dtype=np.float64)
    fp = np.array([(neg >= t).sum() for t in thresholds], dtype=np.float64)
    recall = tp / len(pos)
    aupr = np.sum(np.diff(np.concatenate([[0.0], recall])) * tp / (tp + fp))
    fpr95 = (fp / len(neg))[np.argmax(recall > 0.95)]
    return {"auroc": auroc, "aupr": aupr, "fpr95": fpr95}


@pytest.mark.parametrize("ties", [False, True])
def test_ood_metrics_equal_brute_force(ties):
    rng = np.random.default_rng(5)
    labels = rng.choice(np.array([0, 1, 255], dtype=np.uint8), size=3000, p=[0.7, 0.2, 0.1])
    scores = rng.normal(size=3000).astype(np.float32) + labels.astype(np.float32) * (labels == 1)
    if ties:
        scores = np.round(scores * 4) / 4
    got = ood_metrics(torch.from_numpy(scores), torch.from_numpy(labels))
    want = _brute_force(scores, labels)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
