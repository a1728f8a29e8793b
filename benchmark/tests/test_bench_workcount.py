"""The work counts: the operations of an image equal FlopCounterMode's count on the
reference, and the per-layer shares of a synthetic trace lie in (0, 100] %."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, run, system, workcount
from benchmark.reference import model as ref
from benchmark.trace import Trace

from .tiny import CONFIG_NAMES, REPO, repo_config


def _config(name: str) -> dict:
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_image_flops_equal_flop_counter_on_reference(name):
    cfg, backbone = repo_config(name)
    model = cfg["model"]
    weights = inputs.make_weights(system.parameter_shapes(model), model, 1, "cpu")
    image = torch.randint(0, 256, (64, 96, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        ref.score_map(weights, model, image, backbone=backbone)
    assert workcount.image_flops(model, 64, 96, backbone) == counter.get_total_flops()


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_config_file_records_its_work(name):
    cfg, backbone = repo_config(name)
    assert cfg["flops_per_image"]["1024x2048"] == workcount.image_flops(cfg["model"], 1024, 2048, backbone)
    assert cfg["parameters"] == sum(torch.Size(s).numel() for s in system.parameter_shapes(cfg["model"]).values())


def _event(name, cat, start, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": start, "dur": dur, "pid": 0, "tid": 0}


def _synthetic_run(name: str, kernel_share: float) -> SimpleNamespace:
    """Two requests of 40 ms, each with its layer spans on host and device, Kernel A and
    B kernels taking 1/kernel_share of their least time, and other kernels in between."""
    cfg = _config(name)
    model = cfg["model"]
    a = workcount.least_seconds(*workcount.window_attention_work(model, 1024, 2048, 1), workcount.PEAK_BF16_FLOPS)
    b = workcount.least_seconds(*workcount.fused_rba_work(model, 1024, 2048, 1), workcount.PEAK_SPLIT_TF32_FLOPS)
    events = []
    for r in range(2):
        t = r * 40_000.0
        for layer, (start, dur) in {"backbone": (0, 15_000), "pixel_decoder": (15_000, 10_000),
                                    "transformer_decoder": (25_000, 2_000), "rba_tail": (27_000, 1_000)}.items():
            events += [_event(layer, "user_annotation", t + start, dur), _event(layer, "gpu_user_annotation",
                                                                                 t + start + 500, dur)]
        events += [_event("window_attention_mma_kernel<144, 32, true>", "kernel", t + 600, a * 1e6 / kernel_share),
                   _event("void gemm", "kernel", t + 6_000, 5_000),
                   _event("deform_sampling", "gpu_user_annotation", t + 16_000, 2_000),
                   _event("gather", "kernel", t + 16_100, 1_500),
                   _event("fused_rba_mma_kernel", "kernel", t + 27_600, b * 1e6 / kernel_share),
                   _event("aten::add", "cpu_op", t + 30_000, 5_000)]
    return SimpleNamespace(trace=Trace(events), units=2, window_s=0.08, unprofiled_s=0.04, batch=1, height=1024,
                           width=2048, config=cfg, traffic={}, backbone=None)


@pytest.mark.parametrize("kernel_share", [0.05, 0.5, 1.0])
def test_shares_of_a_synthetic_trace(kernel_share):
    cell = run.Cell("swin_b_1dl.camera", 1, {}, {}, [])
    r = _synthetic_run("swin_b_1dl", kernel_share)
    for metric in ("window_attention_roofline.serve", "fused_rba_roofline.serve"):
        assert run.layer_reader(cell, metric)(r) == pytest.approx(100 * kernel_share)
    for metric in ("device_idle_share.serve", "mfu.serve", "mfu.eval"):
        assert 0 < run.layer_reader(cell, metric)(r) <= 100
    assert run.layer_reader(cell, "deform_sampling_busy_ms.serve")(r) == pytest.approx(1.5)
    assert run.layer_reader(cell, "host_ms_per_request.serve")(r) == pytest.approx(28.0)
    assert r.trace.busy_s() <= r.window_s
