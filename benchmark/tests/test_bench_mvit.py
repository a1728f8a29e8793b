"""The MViT reference (``reference/mvit.py``) against the port's MViTv2-B at its full
widths and depth on the CPU at fp32, on a frame whose windows tile and on one whose
windows are padded, and whole score maps; the sharpness of that comparison; the operation
count and the attention core's work; and the readers of the port's ``rel_pos_attention``
and ``qkv_pool`` spans on a synthetic trace."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, system, workcount
from benchmark.reference import model as ref
from benchmark.trace import Trace

from .test_bench_span_metrics import _event, _read
from .tiny import SCENE, repo_config

TOL = 1e-4  # of each map's span (max − min): fp32 sums in other orders (about 2e-6 here)
# the score (-sum of 19 tanh) of the whole model: fp32 rounding in other orders through the
# backbone, the pixel decoder and the decoder, up to 8e-5 of a score near -17 over seeds 5-7
SCORE_TOL = 1e-3
# 224x448: every stage's windows tile the map (56x112 tokens, windows 56/28/14/7);
# 192x320: 48x80 tokens, so every window attention pads its map
SIZES = [(224, 448), (192, 320)]


@pytest.fixture(scope="module")
def mvit():
    """(the configuration's model at fp32, its reference backbone file, the seed's
    weights, the port's model)."""
    config, backbone = repo_config("mvit_b_1dl")
    model = dict(config["model"], compute_dtype="float32")
    weights = inputs.make_weights(system.parameter_shapes(model), model, 5, "cpu")
    _, net = system.build(model, {k: v.clone() for k, v in weights.items()})
    return model, backbone, weights, net


def _frame(model, hw):
    frame, _ = next(inputs.make_scenes(1, *hw, SCENE, 5, "cpu"))
    return ref.preprocess(model, frame)


def _port_maps(net, x):
    from rba_tpu_torch.models.mvit import mvit_apply

    with torch.no_grad():
        return {k: v.permute(0, 3, 1, 2) for k, v in mvit_apply(net.backbone, x, torch.float32).items()}


def _widest_rel_gap(backbone, weights, model, x, port) -> float:
    """The widest |reference − port| over the reference map's span, over every map."""
    with torch.no_grad():
        want = backbone.features(weights, model, x, ref._same)
    assert set(want) == set(port) == {"scale2", "scale3", "scale4", "scale5"}
    gaps = []
    for name, w in want.items():
        assert w.shape == port[name].shape, name
        gaps.append(float((w - port[name]).abs().max() / (w.max() - w.min())))
    return max(gaps)


@pytest.mark.parametrize("hw", SIZES, ids=["tiled", "padded"])
def test_reference_maps_equal_the_port_at_full_widths(mvit, hw):
    model, backbone, weights, net = mvit
    x = _frame(model, hw)
    port = _port_maps(net, x)
    assert [port[f"scale{s + 2}"].shape[1] for s in range(4)] == [96, 192, 384, 768]
    assert len(backbone.schedule(model)) == 24 and backbone.EPS == 1e-6
    assert _widest_rel_gap(backbone, weights, model, x, port) < TOL


def test_reference_score_map_equals_the_port(mvit):
    from rba_tpu_torch.config import config_from_dict
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    model, backbone, weights, net = mvit
    frame, _ = next(inputs.make_scenes(1, 96, 160, SCENE, 6, "cpu"))
    with torch.no_grad():
        got = maskformer_infer_rba(net, config_from_dict(model), frame)[0]
    want = ref.score_map(weights, model, frame[0], backbone=backbone)
    assert got.shape == want.shape == (96, 160) and float(want.std()) > 0.1
    assert float((got - want).abs().max()) < SCORE_TOL


def _no_rel_pos(backbone, monkeypatch):
    monkeypatch.setattr(backbone, "rel_pos", lambda table, q_size, k_size: torch.zeros(
        q_size, k_size, table.shape[1]))


def _no_residual_pooling(backbone, monkeypatch):
    monkeypatch.setattr(backbone, "MVIT_B", dict(backbone.MVIT_B, residual_pooling=False))


def _one_block_other_kv_stride(backbone, monkeypatch):
    """Block 10 (stage 3, windowed) pools k and v by 2 in place of 1."""
    schedule = backbone.schedule

    def other(model):
        blocks = schedule(model)
        blocks[10] = dict(blocks[10], stride_kv=2)
        return blocks

    monkeypatch.setattr(backbone, "schedule", other)


@pytest.mark.parametrize("fault", [_no_rel_pos, _no_residual_pooling, _one_block_other_kv_stride])
def test_a_changed_reference_misses_the_port(mvit, monkeypatch, fault):
    model, backbone, weights, net = mvit
    x = _frame(model, SIZES[0])
    port = _port_maps(net, x)
    fault(backbone, monkeypatch)
    assert _widest_rel_gap(backbone, weights, model, x, port) > 100 * TOL


@pytest.mark.parametrize("hw", [(64, 96), SIZES[1]])
def test_flops_equal_flop_counter_on_features(mvit, hw):
    model, backbone, weights, _ = mvit
    x = _frame(model, hw)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        maps = backbone.features(weights, model, x, ref._same)
    count, feats = backbone.flops(model, *hw)
    assert count == counter.get_total_flops()
    assert feats == {k: (v.shape[1], v.shape[2] * v.shape[3]) for k, v in maps.items()}


def test_attention_work_at_1024x2048(mvit):
    model, backbone = mvit[:2]
    assert backbone.attention_work(model, 1024, 2048, 1) == (206_844_997_632, 830_269_440)
    assert backbone.attention_work(model, 1024, 2048, 3) == (3 * 206_844_997_632, 3 * 830_269_440)


BLOCKS = 24  # rel_pos_attention and qkv_pool spans per request
GEMM_US, POOL_US, CORE_US = 300.0, 150.0, 400.0


def _synthetic_run(backbone, requests: int = 2, spans: bool = True, core_us: float = CORE_US) -> SimpleNamespace:
    """``requests`` requests, each a ``request`` span on the host whose backbone holds
    ``BLOCKS`` blocks of (GEMM, pooling of two kernels, attention core of two kernels), the
    pooling and the core each in its own device span nested in the backbone's; without
    ``spans`` the trace is the parent's, with neither."""
    config, _ = repo_config("mvit_b_1dl")
    events = []
    for r in range(requests):
        start = r * 100_000.0
        events += [_event("request", "user_annotation", start, 90_000),
                   _event("backbone", "gpu_user_annotation", start, BLOCKS * 2_000)]
        for _ in range(BLOCKS):
            events.append(_event("void gemm", "kernel", start, GEMM_US))
            if spans:
                events += [_event("qkv_pool", "gpu_user_annotation", start + 400, POOL_US),
                           _event("rel_pos_attention", "gpu_user_annotation", start + 800, core_us)]
            events += [_event("conv_depthwise2d", "kernel", start + 400, POOL_US / 2),
                       _event("layer_norm", "kernel", start + 400 + POOL_US / 2, POOL_US / 2),
                       _event("bf16 gemm", "kernel", start + 800, core_us / 2),
                       _event("softmax", "kernel", start + 800 + core_us / 2, core_us / 2)]
            start += 2_000
    return SimpleNamespace(trace=Trace(events), units=requests, window_s=requests * 0.1, unprofiled_s=0.1, batch=1,
                           height=1024, width=2048, config=config, traffic={}, backbone=backbone)


@pytest.mark.parametrize("requests", [1, 3])
def test_rel_pos_and_pool_readers_per_request(mvit, requests):
    backbone = mvit[1]
    r = _synthetic_run(backbone, requests)
    assert _read("rel_pos_attention_busy_ms.serve", r) == pytest.approx(BLOCKS * CORE_US / 1e3)
    assert _read("qkv_pool_busy_ms.serve", r) == pytest.approx(BLOCKS * POOL_US / 1e3)
    # the least time is the bytes at the HBM bandwidth, 0.248 ms
    least = 830_269_440 / workcount.HBM_BYTES_PER_S
    assert least > 206_844_997_632 / workcount.PEAK_BF16_FLOPS
    assert _read("rel_pos_attention_roofline.serve", r) == pytest.approx(100 * least / (BLOCKS * CORE_US / 1e6))
    at_bound = _synthetic_run(backbone, requests, core_us=least * 1e6 / BLOCKS)
    assert _read("rel_pos_attention_roofline.serve", at_bound) == pytest.approx(100.0)
    backbone_ms = _read("backbone_busy_ms.serve", r)
    assert backbone_ms == pytest.approx(BLOCKS * (GEMM_US + POOL_US + CORE_US) / 1e3)
    assert backbone_ms > _read("rel_pos_attention_busy_ms.serve", r) + _read("qkv_pool_busy_ms.serve", r)


def test_rel_pos_and_pool_readers_read_none_without_their_spans(mvit):
    backbone = mvit[1]
    r = _synthetic_run(backbone, spans=False)
    for metric in ("rel_pos_attention_busy_ms.serve", "rel_pos_attention_roofline.serve", "qkv_pool_busy_ms.serve"):
        assert _read(metric, r) is None
    assert _read("backbone_busy_ms.serve", r) == pytest.approx(BLOCKS * (GEMM_US + POOL_US + CORE_US) / 1e3)
    # a configuration without a backbone file that counts the attention's work
    swin = _synthetic_run(backbone)
    swin.backbone = None
    assert _read("rel_pos_attention_roofline.serve", swin) is None


@pytest.mark.parametrize("spans", [True, False])
def test_launches_count_the_operations_inside_the_nested_spans(mvit, spans):
    """The new spans nest in the backbone's device span, which holds their operations:
    every launch of a request is counted, with or without them."""
    r = _synthetic_run(mvit[1], requests=2, spans=spans)
    assert _read("launches_per_request.serve", r) == BLOCKS * 5
