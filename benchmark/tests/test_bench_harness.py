"""The harness end to end on the CPU: a run is correct, its control is not, each fault
that a cell can have turns ``correct`` false, and a configuration, a traffic mix, a
per-layer metric and a configuration's own reference backbone are added as files and
entries alone."""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run, workcount

from .tiny import REPO, TINY_LIMITS, run_tiny, tiny_model, write_root


@pytest.mark.parametrize("workload", ["tiny.cam", "tiny.ev"])
def test_run_is_correct_and_control_is_not(tiny_root, workload):
    res = run_tiny(tiny_root, workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks" and res["checks"]
    names = {"tiny.cam": {"latency_p50_ms", "latency_p95_ms", "setup_s"},
             "tiny.ev": {"eval_images_per_s", "setup_s"}}[workload]
    assert set(res["metrics"]) == names
    assert all(m["value"] > 0 for m in res["metrics"].values())
    control = run_tiny(tiny_root, workload, control=1)
    assert not control["correct"], control["checks"]


def _altered_score(monkeypatch):
    """An answer altered where it is produced: the RbA tail adds 5 to a block of pixels."""
    from rba_tpu_torch.models import maskformer

    real = maskformer.fused_rba_score

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[:, :8, :8] += 5.0
        return out

    monkeypatch.setattr(maskformer, "fused_rba_score", altered)


def _half_batch(monkeypatch):
    """Half of the batch left out: its frames replaced by the other half's."""
    from rba_tpu_torch.models import maskformer

    real = maskformer.preprocess

    def half(cfg, images):
        x = real(cfg, images)
        n = x.shape[0] // 2
        return torch.cat([x[:n], x[:n]]) if n else x

    monkeypatch.setattr(maskformer, "preprocess", half)


def _altered_metric(monkeypatch):
    """An answer altered where it is produced: the evaluation's AUROC off by 0.01."""
    from rba_tpu_torch.evalx import evaluator

    real = evaluator._names
    monkeypatch.setattr(evaluator, "_names", lambda m: dict(real(m), auroc=real(m)["auroc"] + 0.01))


@pytest.mark.parametrize("workload,fault", [("tiny.cam", _altered_score), ("tiny.cam", _half_batch),
                                            ("tiny.ev", _altered_metric), ("tiny.ev", _altered_score)])
def test_fault_makes_run_incorrect(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run_tiny(tiny_root, workload)
    assert not res["correct"], res["checks"]


def test_added_config_traffic_and_metric_are_found(tmp_path):
    """A new configuration, traffic mix and per-layer metric: new files and new entries in
    BENCHMARK.json, no edit of a file the benchmark has."""
    root = write_root(tmp_path)
    bench = root / "benchmark"
    (bench / "configs" / "tiny2.json").write_text(json.dumps({
        "name": "tiny2", "model": dict(tiny_model(), num_classes=5), "limits": json.loads(
            (bench / "configs" / "tiny.json").read_text())["limits"]}))
    (bench / "traffic" / "wide.json").write_text(json.dumps(dict(
        kind="serve", batch=1, height=64, width=128, distinct_requests=2, attention="fused", warmup_requests=1,
        checked_requests=1, traced_requests=2, scene={"stripes": 1, "inliers": 2, "anomalies": 1})))
    (bench / "layer_metrics" / "backbone_spans.serve.py").write_text(
        '"""Host spans of the backbone per request."""\n\n\n'
        'def read(run):\n    return run.trace.span_count("backbone") / run.units\n')
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny2", "source": "test", "file": "benchmark/configs/tiny2.json",
                                "reduced": ["num_classes"], "why": "test"})
    manifest["workloads"].append({"name": "tiny2.wide", "config": "tiny2", "traffic": "wide", "chips": 1,
                                  "why": "test"})
    for metric in manifest["end_to_end"]:
        if metric["name"].startswith("latency"):
            metric["workloads"].append("tiny2.wide")
    manifest["per_layer"].append({"name": "backbone_spans.serve", "unit": "count", "better": "lower",
                                  "source": "program_span", "layer": "backbone", "moves": "latency_p50_ms",
                                  "workloads": ["tiny2.wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = run.load_cell("tiny2.wide", root)
    assert cell.traffic["width"] == 128 and cell.config["model"]["num_classes"] == 5
    assert [m["name"] for m in cell.per_layer] == ["backbone_spans.serve"]
    res = run_tiny(root, "tiny2.wide")
    assert res["correct"] and set(res["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    traced = run_tiny(root, "tiny2.wide", trace=1)
    assert traced["correct"]
    assert traced["metrics"] == {"backbone_spans.serve": {"value": 1.0, "unit": "count"}}
    assert set(traced["device"]) >= {"busy_s", "window_s"} and set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


OWN_BACKBONE = '''"""A configuration's backbone file that hands the work to the reference's ResNet."""
from benchmark import workcount

from .model import resnet


def features(P, model, x, q):
    maps = resnet(P, model["resnet"], x, q)
    maps["res2"] = maps["res2"] + {shift}
    return maps


def flops(model, h, w):
    count, maps = workcount.resnet_flops(model["resnet"], h, w)
    return {scale} * count, maps
'''


def _own_backbone_root(path, shift: float = 0.0, scale: int = 1):
    """A root with the cell ``tinyr.cam``: the tiny model on a ResNet, whose configuration
    names the backbone file ``reference/own.py`` (new files and entries alone)."""
    root = write_root(path)
    bench = root / "benchmark"
    (bench / "reference").mkdir()
    (bench / "reference" / "own.py").write_text(OWN_BACKBONE.format(shift=shift, scale=scale))
    (bench / "configs" / "tinyr.json").write_text(json.dumps({
        "name": "tinyr", "model": dict(tiny_model(), backbone_name="resnet"), "limits": TINY_LIMITS,
        "reference_backbone": "reference/own.py"}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tinyr", "source": "test", "file": "benchmark/configs/tinyr.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tinyr.cam", "config": "tinyr", "traffic": "cam", "chips": 1, "why": "test"})
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "tiny.cam" in metric.get("workloads", []):
            metric["workloads"].append("tinyr.cam")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def test_config_brings_its_own_backbone_file(tmp_path, monkeypatch):
    """The check, the control and ``mfu.serve`` take the backbone from the file that the
    configuration names; delegating to the built-in ResNet, it reads what ResNet reads."""
    root = _own_backbone_root(tmp_path)
    cell = run.load_cell("tinyr.cam", root)
    assert cell.backbone.__file__ == str(root / "benchmark" / "reference" / "own.py")
    model = cell.config["model"]
    assert workcount.image_flops(model, 64, 96, cell.backbone) == workcount.image_flops(model, 64, 96)
    res = run_tiny(root, "tinyr.cam")
    assert res["correct"], res["checks"]
    control = run_tiny(root, "tinyr.cam", control=1)
    assert not control["correct"], control["checks"]
    seen, real = [], workcount.image_flops
    monkeypatch.setattr(workcount, "image_flops", lambda m, h, w, backbone=None: seen.append(backbone) or real(
        m, h, w, backbone))
    traced = run_tiny(root, "tinyr.cam", trace=1)
    assert traced["correct"] and "mfu.serve" in traced["metrics"]
    assert [b.__file__ for b in seen] == [cell.backbone.__file__]


def test_fault_in_backbone_file_makes_run_incorrect(tmp_path):
    res = run_tiny(_own_backbone_root(tmp_path, shift=5.0), "tinyr.cam")
    assert not res["correct"], res["checks"]


def test_backbone_file_count_moves_mfu(tmp_path):
    """A backbone file that counts its operations twice: ``mfu.serve`` reads the backbone's
    share of the request twice."""
    readings = []
    for scale in (1, 2):
        cell = run.load_cell("tinyr.cam", _own_backbone_root(tmp_path / str(scale), scale=scale))
        readings.append(run.layer_reader(cell, "mfu.serve")(SimpleNamespace(
            config=cell.config, backbone=cell.backbone, batch=2, height=64, width=96, unprofiled_s=0.05)))
    model = cell.config["model"]
    backbone = workcount.resnet_flops(model["resnet"], *workcount.padded_hw(model, 64, 96))[0]
    assert readings[1] - readings[0] == pytest.approx(100 * 2 * backbone / 0.05 / workcount.PEAK_BF16_FLOPS)


def test_without_a_card_no_result(tmp_path):
    """No CUDA device: a nonzero exit and nothing on stdout."""
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "swin_b_1dl.camera", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
