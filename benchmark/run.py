"""Run one cell of the benchmark once and print its result as the last line of stdout.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<config>.json``: the port's model, its source, the limits of its check) and
a traffic mix (``traffic/<mix>.json``: the parameters that ``serve_cell`` or
``eval_cell`` reads).  Weights, frames and labels are drawn from ``--seed`` on the card.
With ``--trace 0`` the window is timed and the cell's end-to-end metrics printed; with
``--trace 1`` a stretch of it runs under ``torch.profiler`` and the per-layer metrics
are read from the trace by the readers in ``layer_metrics/<metric>.py``.  After the
window the program is freed and the plain reference (``reference/``) recomputes a
sample of the outputs from the same weights and inputs; ``correct`` says whether each
compared number is within its limit.

``--control 1`` puts the reference, at the precision below the configuration's, in the
program's place (the control of the check); the benchmark's own runs never set it.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rba_tpu")  # top-level module names no run may load
WORK_DIR = Path("build") / "benchmark"  # under the checkout: caches and traces
PROFILER_WARMUP = 2  # requests that start the profiler up before its recorded stretch


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict] = field(default_factory=list)  # the per-layer metrics it reports
    folder: Path = ROOT / "benchmark"  # the benchmark's folder, which holds the readers
    backbone: object = None  # the configuration's reference backbone file, if it names one


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its configuration and traffic files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry_config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    bench = root / Path(manifest["paths"][0])
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    config = json.loads((root / entry_config["file"]).read_text())
    return Cell(name, entry["chips"], config, json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text()),
                e2e, per_layer, bench, reference_backbone(config, bench))


def _load(path: Path, name: str):
    """The module of the file ``path``, executed under the name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_reader(cell: Cell, metric: str) -> Callable:
    """``read`` of ``layer_metrics/<metric>.py``."""
    return _load(cell.folder / "layer_metrics" / f"{metric}.py",
                 f"benchmark_layer_metric_{metric.replace('.', '_')}").read


def reference_backbone(config: dict, folder: Path):
    """The backbone file that ``config`` names under ``reference_backbone``, a path under
    ``folder`` (the contract: ``reference/__init__.py``), loaded as a module of the
    benchmark's package so that its relative imports reach the reference's helpers; None
    without the key, where the reference's own Swin or ResNet serves."""
    path = config.get("reference_backbone")
    if path is None:
        return None
    return _load(folder / path, f"{__package__}.{Path(path).with_suffix('').as_posix().replace('/', '.')}")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _percentile(values: List[float], pct: int) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1] if len(values) > 1 else values[0]


# ---------------------------------------------------------------------------
# Serving: a closed loop of requests, one after the other
# ---------------------------------------------------------------------------

def _serve_loop(serve, requests, seconds: float, keep: int, rng):
    """Serve ``requests`` in turn until ``seconds`` have passed and at least ``keep`` are
    done: (latencies in s, a reservoir sample of ``keep`` (index, output) drawn with ``rng``)."""
    lat, kept = [], []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        out = serve(requests[i % len(requests)])
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if len(kept) < keep:
            kept.append((i, out))
        else:
            j = int(rng.integers(0, i + 1))
            if j < keep:
                kept[j] = (i, out)
        i += 1
        if t1 - start >= seconds and i >= keep:
            return lat, kept


@dataclass
class Window:
    """What a window produced: its end-to-end values, what the check compares, and in a
    traced run what the per-layer readers read."""
    e2e: Dict[str, float]
    attempted: int
    layer: Optional[SimpleNamespace] = None
    kept: list = field(default_factory=list)  # serving: the sampled (request index, output)
    requests: list = field(default_factory=list)  # serving: the distinct requests' frames
    passes: list = field(default_factory=list)  # evaluation: each pass's metrics
    dataset: object = None  # evaluation: the val set
    fallbacks: int = 0  # evaluation: passes recomputed on the exact all-pixel path


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _profile_steps(step, n: int, warm: int):
    """torch.profiler (CPU and CUDA) over ``n`` calls of ``step`` after ``warm`` calls that
    start it up unrecorded: (the profiler, the wall seconds of the ``n`` calls)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=n, repeat=1)) as prof:
        for i in range(warm + n):
            if i == warm:
                _sync()
                t0 = time.perf_counter()
            step()
            if i == warm + n - 1:
                _sync()
                wall = time.perf_counter() - t0
            prof.step()
    return prof, wall


def _read_profile(cell: Cell, prof):
    from . import trace as tr

    WORK_DIR.mkdir(parents=True, exist_ok=True)
    return tr.read_trace(prof, WORK_DIR / f"{cell.name}.trace.json")


def serve_cell(cell: Cell, args, device, program) -> Window:
    """Set-up and window of a serving cell: the seed's frames in host memory, warm-up
    requests, then a closed loop of requests for ``--seconds``."""
    import numpy as np
    import torch

    from . import inputs

    t = cell.traffic
    b, h, w = t["batch"], t["height"], t["width"]
    frames = torch.cat([img.cpu() for img, _ in inputs.make_scenes(t["distinct_requests"] * b, h, w, t["scene"],
                                                                   args.seed, device)])
    requests = [frames[i * b:(i + 1) * b].contiguous() for i in range(t["distinct_requests"])]
    serve = program.serve(cell)
    for i in range(t["warmup_requests"]):
        serve(requests[i % len(requests)])
    rng = np.random.default_rng(inputs.subseed(args.seed, "sample"))
    keep, layer = t["checked_requests"], None
    program.window_starts()
    lat, kept = _serve_loop(serve, requests, args.seconds, keep, rng)
    program.window_ends()
    if args.trace:  # after the unprofiled window, a profiled stretch of the same loop
        turn = itertools.count()
        prof, wall = _profile_steps(lambda: serve(requests[next(turn) % len(requests)]), t["traced_requests"],
                                    PROFILER_WARMUP)
        layer = SimpleNamespace(trace=_read_profile(cell, prof), units=t["traced_requests"], window_s=wall,
                                unprofiled_s=statistics.median(lat), batch=b, height=h, width=w)
        _log(f"profiled stretch {wall / t['traced_requests'] * 1e3:.3f} ms per request; "
             f"unprofiled median {statistics.median(lat) * 1e3:.3f} ms over {len(lat)} requests")
    e2e = {"latency_p50_ms": statistics.median(lat) * 1e3, "latency_p95_ms": _percentile(lat, 95) * 1e3}
    return Window(e2e, len(lat), layer, kept=kept, requests=requests)


# ---------------------------------------------------------------------------
# Evaluation: whole passes of the OOD evaluation over a seeded val set
# ---------------------------------------------------------------------------

class Scenes:
    """A val set of (H, W, 3) uint8 images with (H, W) uint8 labels, as a dataset reader
    hands them over: iterable, one ``Sample``-like object per frame."""

    def __init__(self, images, labels):
        self.samples = [SimpleNamespace(image=i, label=lab, name=str(k)) for k, (i, lab) in
                        enumerate(zip(images, labels))]

    def __len__(self):
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)


def eval_cell(cell: Cell, args, device, program) -> Window:
    """Set-up and window of an evaluation cell: the seed's val set in host memory, a
    warm-up pass, then whole passes until one crosses ``--seconds``."""
    from . import inputs

    t = cell.traffic
    images, labels = [], []
    for img, lab in inputs.make_scenes(t["frames"], t["height"], t["width"], t["scene"], args.seed, device):
        images += list(img.cpu().numpy())
        labels += list(lab.cpu().numpy())
    dataset = Scenes(images, labels)
    evaluate = _counting_fallbacks(program.evaluate(cell))
    for _ in range(t["warmup_passes"]):
        evaluate(dataset)
    evaluate.fallbacks = 0
    layer = None
    program.window_starts()
    passes, n = [], len(dataset)
    start = time.perf_counter()
    while True:
        passes.append(evaluate(dataset))
        elapsed = time.perf_counter() - start
        if elapsed >= args.seconds:
            break
    unprofiled = len(passes)
    program.window_ends()
    if args.trace:  # after the unprofiled window, profiled passes
        prof, wall = _profile_steps(lambda: passes.append(evaluate(dataset)), t["traced_passes"], 1)
        layer = SimpleNamespace(trace=_read_profile(cell, prof), units=t["traced_passes"] * n, window_s=wall,
                                unprofiled_s=elapsed / (unprofiled * n), batch=1, height=t["height"],
                                width=t["width"])
        _log(f"profiled stretch {wall / (t['traced_passes'] * n) * 1e3:.3f} ms per image; "
             f"unprofiled {layer.unprofiled_s * 1e3:.3f} ms per image over {unprofiled} passes")
    _log(f"{evaluate.fallbacks} of {len(passes)} passes fell back to the exact all-pixel path")
    return Window({"eval_images_per_s": unprofiled * n / elapsed}, len(passes) * n, layer, passes=passes,
                  dataset=dataset, fallbacks=evaluate.fallbacks)


def _counting_fallbacks(evaluate):
    """``evaluate``, counting in ``.fallbacks`` the passes whose streamed metrics were not
    certified, which the evaluator then recomputes on its exact all-pixel path."""
    def counted(dataset):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = evaluate(dataset)
        counted.fallbacks += any("not certified" in str(w.message) for w in caught)
        return out

    counted.fallbacks = 0
    return counted


# ---------------------------------------------------------------------------
# The program, and the reference in its place (the control)
# ---------------------------------------------------------------------------

class Program:
    """The port: built from the configuration and the seed's weights, freed after the window."""

    def __init__(self, cell: Cell, seed: int, device, t0: float):
        from . import inputs, system

        self.t0 = t0
        model = cell.config["model"]
        system.build_kernels(device)
        weights = inputs.make_weights(system.parameter_shapes(model), model, seed, device)
        self.cfg, self.net = system.build(model, weights)
        self.device = device

    def serve(self, cell: Cell):
        from . import system

        return system.serve_fn(self.cfg, self.net, cell.traffic["attention"])

    def evaluate(self, cell: Cell):
        from . import system

        return system.evaluate_fn(self.cfg, self.net, cell.traffic)

    def window_starts(self):
        """Set-up ends here: from the process's start to the first timed request."""
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gc.collect()
        gc.freeze()  # set-up's objects leave the collector's scans: no full collection walks them in the window
        self.setup_s = time.perf_counter() - self.t0

    def window_ends(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            self.peak_bytes = torch.cuda.max_memory_allocated()
        else:
            self.peak_bytes = 0

    def free(self):
        import torch

        self.cfg = self.net = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


class Control(Program):
    """The reference at the precision below the configuration's, in the program's place."""

    def __init__(self, cell: Cell, seed: int, device, t0: float):
        from . import inputs, system

        model = cell.config["model"]
        self.model, self.backbone, self.device, self.t0 = model, cell.backbone, device, t0
        self.weights = inputs.make_weights(system.parameter_shapes(model), model, seed, device)

    def _maps(self, frames):
        import torch

        from .reference import model as ref

        return torch.stack([ref.score_map(self.weights, self.model, f.to(self.device), lowp=True,
                                          backbone=self.backbone) for f in frames])

    def serve(self, cell: Cell):
        return lambda frames: self._maps(frames).cpu()

    def evaluate(self, cell: Cell):
        import torch

        from .reference.ood_metrics import ood_metrics

        def evaluate(dataset, limit: int = 1300):
            imgs = torch.stack([torch.from_numpy(s.image) for s in dataset])
            labels = torch.stack([torch.from_numpy(s.label) for s in dataset]).to(self.device)
            return ood_metrics(self._maps(imgs), labels)

        return evaluate

    def free(self):
        self.weights = None
        super().free()


# ---------------------------------------------------------------------------
# The check: the reference recomputes what the window produced
# ---------------------------------------------------------------------------

def check(cell: Cell, win: Window, seed: int, device):
    """(numbers compared, failed outputs): the reference's weights are drawn again from
    the seed, and the reference runs image by image.  Of the sampled maps: the widest
    |served − reference| over the span (max − min) of the reference's map, the widest
    |served − reference|, and its mean."""
    import torch

    from . import inputs, system
    from .reference import model as ref
    from .reference.ood_metrics import ood_metrics

    model = cell.config["model"]
    weights = inputs.make_weights(system.parameter_shapes(model), model, seed, device)
    failed = 0
    if cell.traffic["kind"] == "serve":
        b, h, w = cell.traffic["batch"], cell.traffic["height"], cell.traffic["width"]
        worst = total = count = rel = 0.0
        for idx, out in win.kept:
            frames = win.requests[idx % len(win.requests)]
            if tuple(out.shape) != (b, h, w) or not bool(torch.isfinite(out).all()):
                failed += 1
                continue
            for k in range(b):
                want = ref.score_map(weights, model, frames[k].to(device), backbone=cell.backbone)
                gap = (out[k].to(device) - want).abs()
                worst, total, count = max(worst, float(gap.max())), total + float(gap.sum()), count + gap.numel()
                rel = max(rel, float(gap.max() / (want.max() - want.min())))
        return {"score_max_rel_gap": rel, "score_max_gap": worst, "score_mean_gap": total / max(count, 1)}, failed
    scores = torch.stack([ref.score_map(weights, model, torch.from_numpy(s.image).to(device), backbone=cell.backbone)
                          for s in win.dataset])
    labels = torch.stack([torch.from_numpy(s.label) for s in win.dataset]).to(device)
    want = ood_metrics(scores, labels)
    gaps = {f"{k}_gap": 0.0 for k in want}
    for got in win.passes:
        if set(got) != set(want):
            failed += 1
            continue
        for k in want:
            gaps[f"{k}_gap"] = max(gaps[f"{k}_gap"], abs(float(got[k]) - want[k]))
    return gaps, failed


def judge(cell: Cell, numbers: Dict[str, float], failed: int):
    """(correct, {name: {"value", "limit"}}): every number that has a limit in the
    configuration file for the traffic's kind is compared; none compared is not correct."""
    limits = cell.config.get("limits", {}).get(cell.traffic["kind"], {})
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    correct = failed == 0 and bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


# ---------------------------------------------------------------------------

def run_cell(cell: Cell, args, device="cuda", t0: float = T0) -> dict:
    """One run of the cell: set-up, window, per-layer readings, check.  The result's keys
    are the driver's, with ``checks`` last."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = (Control if args.control else Program)(cell, args.seed, device, t0)
    runner = serve_cell if cell.traffic["kind"] == "serve" else eval_cell
    win = runner(cell, args, device, program)
    program.free()

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = layer_reader(cell, m["name"])(SimpleNamespace(**vars(win.layer), config=cell.config,
                                                                  traffic=cell.traffic, backbone=cell.backbone))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.e2e, setup_s=program.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    numbers, failed = check(cell, win, args.seed, device)
    correct, checks = judge(cell, numbers, failed)
    is_cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": program.peak_bytes}
    result = {"correct": correct, "attempted": win.attempted, "failed": failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev.update(busy_s=win.layer.trace.busy_s(), window_s=win.layer.window_s)
        from .system import LAYERS_SPANS

        result["breakdown"] = {"device_ops": win.layer.trace.top_device_ops(10),
                               "idle_gaps": win.layer.trace.idle_gaps(LAYERS_SPANS, 10)}
    if cell.traffic["kind"] == "ood_eval":
        result["exact_fallback_passes"] = win.fallbacks
    result["readings"] = numbers  # every number the check computed; those with a limit are in checks
    result["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare_environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX on its own."""
    cache = (ROOT / WORK_DIR / "cache").resolve()
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    args = parse_args(argv)
    os.chdir(ROOT)
    prepare_environment()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args)
    found = forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
