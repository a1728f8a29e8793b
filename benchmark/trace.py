"""Reading a profiler trace (torch.profiler's Chrome-trace JSON): the device's
operations, the program's ``record_function`` spans on the host and on the device,
busy time, and the breakdown of device time and idle gaps.

A layer's busy time counts the device operations that start inside the layer's
device-side span (the span's first to last kernel), as the port's smoke run counts
them.  Times in the trace are microseconds; this module returns seconds."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120  # device-op names are cut to this length in the breakdown
SHORT_GAP_US = 10.0


class Trace:
    def __init__(self, events: Iterable[dict]):
        device, dev_spans, host_spans, host_ops = [], defaultdict(list), defaultdict(list), []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end, name, cat = float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""), e.get("cat")
            if cat in DEVICE_CATEGORIES:
                device.append((start, end, name))
            elif cat == "gpu_user_annotation":
                dev_spans[name].append((start, end))
            elif cat == "user_annotation":
                host_spans[name].append((start, end))
            elif cat == "cpu_op":
                host_ops.append((start, end, name))
        self.device = sorted(device)
        self._starts = [d[0] for d in self.device]
        self.device_spans: Dict[str, List[Tuple[float, float]]] = dict(dev_spans)
        self.host_spans: Dict[str, List[Tuple[float, float]]] = dict(host_spans)
        self.host_ops = sorted(host_ops)
        self._op_starts = [o[0] for o in self.host_ops]

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def _merged(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of their intervals)."""
        return sum(b - a for a, b in self._merged()) / 1e6

    def _inside(self, names: Iterable[str]) -> set:
        """Indices of the device operations that start inside a device span of ``names``."""
        idx = set()
        for name in names:
            for start, end in self.device_spans.get(name, ()):
                lo, hi = bisect.bisect_left(self._starts, start), bisect.bisect_left(self._starts, end)
                idx.update(range(lo, hi))
        return idx

    def busy_in_spans(self, names: Iterable[str]) -> float:
        """Device seconds of the operations that start inside the spans ``names``."""
        return sum(self.device[i][1] - self.device[i][0] for i in self._inside(names)) / 1e6

    def busy_outside_spans(self, names: Iterable[str]) -> float:
        """Device seconds of the operations that start inside none of the spans ``names``."""
        inside = self._inside(names)
        return sum(d[1] - d[0] for i, d in enumerate(self.device) if i not in inside) / 1e6

    def kernel_s(self, patterns: Iterable[str]) -> float:
        """Device seconds of the operations whose name contains one of ``patterns``."""
        patterns = tuple(patterns)
        return sum(d[1] - d[0] for d in self.device if any(p in d[2] for p in patterns)) / 1e6

    def host_span_s(self, names: Iterable[str]) -> float:
        """Host seconds inside the spans ``names`` (summed over their occurrences)."""
        return sum(b - a for name in names for a, b in self.host_spans.get(name, ())) / 1e6

    def span_count(self, name: str) -> int:
        return len(self.host_spans.get(name, ()))

    def top_device_ops(self, k: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for start, end, name in self.device:
            total[name[:NAME_CHARS]] += (end - start) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda r: -r[1])[:k]]

    def _host_label(self, t: float, span_names: Iterable[str]) -> str:
        """What the host was doing at ``t``: the innermost of the spans ``span_names`` and
        the innermost host operation that hold ``t``."""
        span = "outside the spans"
        best = None
        for name in span_names:
            for start, end in self.host_spans.get(name, ()):
                if start <= t < end and (best is None or start > best):
                    best, span = start, name
        op = "no operation"
        i = bisect.bisect_right(self._op_starts, t)
        for start, end, name in reversed(self.host_ops[max(0, i - 200):i]):
            if end > t:
                op = name
                break
        return f"{span} / {op}"

    def idle_gaps(self, span_names: Iterable[str], k: int = 10) -> List[list]:
        """The idle time between device operations, summed by what the host was doing in
        the middle of each gap (gaps shorter than ``SHORT_GAP_US`` under one name), the
        largest first."""
        span_names = tuple(span_names)
        total: Dict[str, float] = defaultdict(float)
        merged = self._merged()
        for (_, a), (b, _) in zip(merged, merged[1:]):
            label = self._host_label((a + b) / 2, span_names) if b - a >= SHORT_GAP_US else "gaps under 10 us"
            total[label] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda r: -r[1])[:k]]


def read_trace(prof, path) -> Trace:
    """Export ``prof``'s trace to ``path`` and read it back."""
    prof.export_chrome_trace(str(path))
    return Trace.load(path)
