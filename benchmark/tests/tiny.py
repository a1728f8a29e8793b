"""Helpers of the benchmark's CPU tests: a benchmark root in a temporary directory whose
cells run a tiny model at fp32 on the CPU, through the same harness as the real cells."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIG_NAMES = sorted(p.stem for p in (REPO / "benchmark" / "configs").glob("*.json"))  # every configuration file
SCENE = {"stripes": 2, "inliers": 3, "anomalies": 1}
TINY_LIMITS = {"serve": {"score_max_rel_gap": 1e-3, "score_mean_gap": 1e-3},
               "ood_eval": {"auroc_gap": 1e-3, "aupr_gap": 1e-3, "fpr95_gap": 1e-3}}


def tiny_model() -> dict:
    from rba_tpu_torch.config import tiny_test_config

    return json.loads(json.dumps(dataclasses.asdict(tiny_test_config())))


def repo_config(name: str):
    """(the benchmark's configuration file ``name``, the backbone file it names or None)."""
    from benchmark import run

    folder = REPO / "benchmark"
    config = json.loads((folder / "configs" / f"{name}.json").read_text())
    return config, run.reference_backbone(config, folder)


def write_root(root: Path, traffic_batch: int = 2) -> Path:
    """A copy of the benchmark's manifest and readers whose only cells are ``tiny.cam``
    (serving, batch ``traffic_batch``) and ``tiny.ev`` (evaluation) on a tiny fp32 model."""
    bench = root / "benchmark"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    shutil.copytree(REPO / "benchmark" / "layer_metrics", bench / "layer_metrics")
    (bench / "configs" / "tiny.json").write_text(json.dumps({"name": "tiny", "model": tiny_model(),
                                                             "limits": TINY_LIMITS}))
    (bench / "traffic" / "cam.json").write_text(json.dumps(dict(
        kind="serve", batch=traffic_batch, height=64, width=96, distinct_requests=3, attention="fused",
        warmup_requests=1, checked_requests=2, traced_requests=2, scene=SCENE)))
    (bench / "traffic" / "ev.json").write_text(json.dumps(dict(
        kind="ood_eval", frames=3, height=64, width=96, score="rba", cohort=1, attention="fused",
        warmup_passes=1, traced_passes=1, scene=SCENE)))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "tiny", "source": "tiny_test_config", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a CPU test"}]
    manifest["workloads"] = [{"name": "tiny.cam", "config": "tiny", "traffic": "cam", "chips": 1, "why": "test"},
                             {"name": "tiny.ev", "config": "tiny", "traffic": "ev", "chips": 1, "why": "test"}]
    if not any(m["name"] == "eval_images_per_s" for m in manifest["end_to_end"]):  # no real cell evaluates yet
        manifest["end_to_end"].append({"name": "eval_images_per_s", "unit": "images/s", "better": "higher",
                                       "bound": 0.05, "source": "host_clock", "workloads": []})
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in metric:
            served = metric["name"].startswith("latency") or metric["name"].endswith(".serve")
            metric["workloads"] = ["tiny.cam"] if served else ["tiny.ev"]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run_tiny(root: Path, workload: str, seed: int = 2**31 + 11, trace: int = 0, control: int = 0) -> dict:
    """One run of a cell of ``root`` on the CPU, past the harness's look for a card."""
    import time

    from benchmark import run

    cell = run.load_cell(workload, root)
    args = run.parse_args(["--workload", workload, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace),
                           "--control", str(control)])
    return run.run_cell(cell, args, device="cpu", t0=time.perf_counter())

