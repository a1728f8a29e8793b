"""Tracing and timing utilities (counterpart of ``rba_tpu/utils/profiling.py``).

``device_trace`` records a ``torch.profiler`` trace of the host and, on the card, of its
kernels (CUPTI), and writes it to ``logdir`` as a Chrome/Perfetto trace, which
TensorBoard's profiler plugin also reads.  ``StageTimer`` accumulates wall-clock times
per stage; a stage that names what it computed (``sync``) waits for it first
(``force_sync``), so the time covers the device's work and not only its launch.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


@contextlib.contextmanager
def device_trace(logdir: str = "rba_trace"):
    """Profile the block (CPU, and CUDA where a card is present); on exit write
    ``logdir/trace.json``.  Yields the profiler, whose ``key_averages()`` tables the
    recorded ops and kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def force_sync(tree) -> float:
    """Wait for every tensor of a tree (tensors, dicts, lists) and return their sum as a
    checksum: the device-to-host copy of the sum is the wait."""
    total = 0.0
    for leaf in _leaves(tree):
        if not leaf.is_complex():
            total += float(leaf.detach().float().sum())
    return total


class StageTimer:
    """Accumulate per-stage wall-clock times across iterations."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            force_sync(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / self.counts[k] for k in self.totals}

    def report(self) -> str:
        return json.dumps({k: round(v * 1000, 2) for k, v in self.summary().items()})
