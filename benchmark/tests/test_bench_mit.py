"""The MiT reference (``reference/mit.py``) against the port's MiT-B5 at its full widths
and depth on the CPU at fp32, with the port's LayerNorm eps and with the published ones;
the sharpness of that comparison; the attention core's work at 1024x2048; and the
readers of the port's ``sr_attention`` spans on a synthetic trace."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import inputs, system, workcount
from benchmark.reference import model as ref
from benchmark.trace import Trace

from .test_bench_span_metrics import _event, _read
from .tiny import SCENE, repo_config

TOL = 1e-4  # of each map's span (max − min): fp32 sums in other orders (about 1e-6 here)
# The reference's published eps 1e-5 in the patch embeds' and the reductions' LayerNorms,
# where the port takes 1e-6, moves the tokens of low variance (flat patches of the image):
# 1.1e-5 to 1.26e-4 of the span over seeds 1-20 at 64x96.
TOL_PUBLISHED_EPS = 5e-4
HW = (64, 96)


@pytest.fixture(scope="module")
def mit():
    """(the configuration's model at fp32, its reference backbone file, the seed's
    weights, the port's model, a normalised padded frame)."""
    config, backbone = repo_config("mit_b5_1dl")
    model = dict(config["model"], compute_dtype="float32")
    weights = inputs.make_weights(system.parameter_shapes(model), model, 5, "cpu")
    _, net = system.build(model, {k: v.clone() for k, v in weights.items()})
    frame, _ = next(inputs.make_scenes(1, *HW, SCENE, 5, "cpu"))
    return model, backbone, weights, net, ref.preprocess(model, frame)


def _port_maps(net, x):
    from rba_tpu_torch.models.mix_transformer import mit_apply

    with torch.no_grad():
        return {k: v.permute(0, 3, 1, 2) for k, v in mit_apply(net.backbone, x, torch.float32).items()}


def _widest_rel_gap(backbone, weights, model, x, port) -> float:
    """The widest |reference − port| over the reference map's span, over every map."""
    with torch.no_grad():
        want = backbone.features(weights, model, x, ref._same)
    assert set(want) == set(port) == {"res2", "res3", "res4", "res5"}
    gaps = []
    for name, w in want.items():
        assert w.shape == port[name].shape, name
        gaps.append(float((w - port[name]).abs().max() / (w.max() - w.min())))
    return max(gaps)


def _port_eps(backbone, monkeypatch):
    """The reference with the port's single LayerNorm eps, 1e-6."""
    monkeypatch.setattr(backbone, "PATCH_EPS", 1e-6)
    monkeypatch.setattr(backbone, "SR_EPS", 1e-6)


@pytest.mark.parametrize("eps,tol", [("port", TOL), ("published", TOL_PUBLISHED_EPS)])
def test_reference_maps_equal_the_port_at_full_widths(mit, monkeypatch, eps, tol):
    model, backbone, weights, net, x = mit
    assert backbone.VARIANTS[model["backbone_name"]]["depths"] == (3, 6, 40, 3)
    assert (backbone.BLOCK_EPS, backbone.PATCH_EPS, backbone.SR_EPS) == (1e-6, 1e-5, 1e-5)
    port = _port_maps(net, x)
    assert [port[f"res{s + 2}"].shape[1] for s in range(4)] == [64, 128, 320, 512]
    if eps == "port":
        _port_eps(backbone, monkeypatch)
    assert _widest_rel_gap(backbone, weights, model, x, port) < tol


def _stage1_ratio_4(backbone, monkeypatch):
    monkeypatch.setitem(backbone.VARIANTS, "mit_b5", dict(backbone.VARIANTS["mit_b5"], sr_ratios=(4, 4, 2, 1)))


def _one_block_other_heads(backbone, monkeypatch):
    """The second block of stage 4 attends with 4 heads of 128 in place of 8 of 64."""
    block = backbone._block

    def other(P, pre, x, h, w, heads, sr, q):
        return block(P, pre, x, h, w, 4 if pre == "backbone.stages.3.blocks.1" else heads, sr, q)

    monkeypatch.setattr(backbone, "_block", other)


@pytest.mark.parametrize("fault", [_stage1_ratio_4, _one_block_other_heads])
def test_a_changed_reference_misses_the_port(mit, monkeypatch, fault):
    model, backbone, weights, net, x = mit
    port = _port_maps(net, x)
    _port_eps(backbone, monkeypatch)
    fault(backbone, monkeypatch)
    assert _widest_rel_gap(backbone, weights, model, x, port) > 100 * TOL


def test_attention_work_at_1024x2048(mit):
    model, backbone = mit[:2]
    assert backbone.attention_work(model, 1024, 2048, 1) == (1_297_080_123_392, 758_644_736)
    assert backbone.attention_work(model, 1024, 2048, 4) == (4 * 1_297_080_123_392, 4 * 758_644_736)


BLOCKS = 52  # sr_attention spans per request
CORE_US, GEMM_US = 800.0, 300.0


def _synthetic_run(backbone, requests: int = 2, spans: bool = True, core_us: float = CORE_US) -> SimpleNamespace:
    """``requests`` requests whose backbone holds ``BLOCKS`` (GEMM, attention core) pairs,
    each core of two kernels in its own ``sr_attention`` device span; without ``spans``
    the trace is the parent's, with no such span."""
    config, _ = repo_config("mit_b5_1dl")
    events = []
    for r in range(requests):
        start = r * 100_000.0
        events.append(_event("backbone", "gpu_user_annotation", start, BLOCKS * 2_000))
        for _ in range(BLOCKS):
            events.append(_event("void gemm", "kernel", start, GEMM_US))
            if spans:
                events.append(_event("sr_attention", "gpu_user_annotation", start + 500, core_us))
            events += [_event("bf16 gemm", "kernel", start + 500, core_us / 2),
                       _event("softmax", "kernel", start + 500 + core_us / 2, core_us / 2)]
            start += 2_000
    return SimpleNamespace(trace=Trace(events), units=requests, window_s=requests * 0.1, unprofiled_s=0.1, batch=1,
                           height=1024, width=2048, config=config, traffic={}, backbone=backbone)


@pytest.mark.parametrize("requests", [1, 3])
def test_sr_attention_readers_per_request(mit, requests):
    backbone = mit[1]
    r = _synthetic_run(backbone, requests)
    assert _read("sr_attention_busy_ms.serve", r) == pytest.approx(BLOCKS * CORE_US / 1e3)
    # the least time is the operations at the bf16 peak, 1.31 ms
    least = 1_297_080_123_392 / workcount.PEAK_BF16_FLOPS
    assert _read("sr_attention_roofline.serve", r) == pytest.approx(100 * least / (BLOCKS * CORE_US / 1e6))
    at_bound = _synthetic_run(backbone, requests, core_us=least * 1e6 / BLOCKS)
    assert _read("sr_attention_roofline.serve", at_bound) == pytest.approx(100.0)
    assert _read("sr_attention_busy_ms.serve", r) < _read("backbone_busy_ms.serve", r)


def test_sr_attention_readers_read_none_without_their_span(mit):
    backbone = mit[1]
    r = _synthetic_run(backbone, spans=False)
    assert _read("sr_attention_busy_ms.serve", r) is None
    assert _read("sr_attention_roofline.serve", r) is None
    assert _read("backbone_busy_ms.serve", r) == pytest.approx(BLOCKS * (GEMM_US + CORE_US) / 1e3)
    # a configuration without a backbone file that counts the attention's work
    swin = _synthetic_run(backbone)
    swin.backbone = None
    assert _read("sr_attention_roofline.serve", swin) is None
