"""Readings that set the limits of a cell's check, in one process on the card: the
numbers the check compares, from the program on many seeds and from the control (the
reference at the precision below the configuration's) on a few, each run at the cell's
own size through the cell's own window; and the spread of the deformable sampling's
offsets, in pixels of their level, under the seed's weights.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1:13 --control-seeds 101:104 \\
        --seconds 2 --out chiprun_out/calibrate_<cell>.json
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from . import run


def _seeds(text: str):
    if ":" in text:
        lo, hi = (int(x) for x in text.split(":"))
        return list(range(lo, hi))
    return [int(x) for x in text.split(",") if x]


def offset_spread(cell: run.Cell, seed: int, device) -> dict:
    """Percentiles of |sampling offset| (in pixels of the level sampled) of every encoder
    layer's queries, heads and points, on the cell's first frame, from the reference."""
    import torch

    from . import inputs, system
    from .reference import model as ref

    model, t = cell.config["model"], cell.traffic
    weights = inputs.make_weights(system.parameter_shapes(model), model, seed, device)
    frame, _ = next(inputs.make_scenes(1, t["height"], t["width"], t["scene"], seed, device))
    norms = []
    linear = ref._linear

    def recording(P, name, x, q=ref._same):
        y = linear(P, name, x, q)
        if name.endswith("sampling_offsets"):
            norms.append(y.reshape(-1, 2).norm(dim=-1))
        return y

    ref._linear = recording
    try:
        ref.score_map(weights, model, frame[0])
    finally:
        ref._linear = linear
    allv = torch.cat(norms)
    qs = torch.quantile(allv[torch.randperm(allv.numel(), device=allv.device)[:1_000_000]],
                        torch.tensor([0.1, 0.5, 0.9], device=allv.device))
    return {"p10_px": float(qs[0]), "median_px": float(qs[1]), "p90_px": float(qs[2]),
            "share_over_1px": float((allv > 1).float().mean())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--offsets", type=int, default=0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    run.prepare_environment()
    cell = run.load_cell(a.workload)
    out = {"workload": a.workload, "program": {}, "control": {}}
    for kind, seeds in (("program", _seeds(a.seeds)), ("control", _seeds(a.control_seeds))):
        for seed in seeds:
            args = run.parse_args(["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
                                   "--control", str(int(kind == "control"))])
            t0 = time.perf_counter()
            res = run.run_cell(cell, args, t0=t0)
            out[kind][seed] = dict(res["readings"], correct=res["correct"], failed=res["failed"],
                                   seconds=time.perf_counter() - t0, fallbacks=res.get("exact_fallback_passes", 0))
            print(kind, seed, json.dumps(out[kind][seed]), flush=True)
    for kind in ("program", "control"):
        if out[kind]:
            names = next(iter(out[kind].values())).keys()
            out[f"{kind}_max"] = {k: max(r[k] for r in out[kind].values()) for k in names
                                  if k not in ("correct", "failed", "seconds", "fallbacks")}
            out[f"{kind}_min"] = {k: min(r[k] for r in out[kind].values()) for k in names
                                  if k not in ("correct", "failed", "seconds", "fallbacks")}
            out[f"{kind}_median"] = {k: statistics.median(r[k] for r in out[kind].values()) for k in names
                                     if k not in ("correct", "failed", "seconds", "fallbacks")}
    if a.offsets:
        out["offset_spread"] = offset_spread(cell, _seeds(a.seeds)[0], "cuda")
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k not in ("program", "control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
