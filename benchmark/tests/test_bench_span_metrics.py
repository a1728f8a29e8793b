"""The readers of the port's ``request``, ``upload`` and ``window_attention`` spans, on a
synthetic trace: each counts, or sums the device time of, the operations that start
inside its spans, per request, and reads ``None`` where the trace has no such span."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.trace import Trace

BLOCKS = 3  # Kernel A calls per request
UPLOAD_US, KERNEL_A_US, GEMM_US, DOWNLOAD_US = 400.0, 60.0, 900.0, 300.0


def _event(name, cat, start, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": start, "dur": dur, "pid": 0, "tid": 0}


def _synthetic_run(requests: int = 2, request_on_device: bool = False, spans: bool = True) -> SimpleNamespace:
    """``requests`` requests of 10 ms.  In each: the upload (a copy), then a backbone of
    ``BLOCKS`` (Kernel A, GEMM) pairs, each Kernel A in its own span, then the map's
    download after the request, which no span of the port holds.  The profiler mirrors a
    span on the device from its first to its last operation whose innermost span it is;
    ``request_on_device`` adds the whole request's device span as well, and without
    ``spans`` the trace is the parent's: no ``request``, ``upload`` or
    ``window_attention`` span."""
    events = []
    for r in range(requests):
        t = r * 10_000.0
        if spans:
            events.append(_event("request", "user_annotation", t, 8_000))
            events.append(_event("upload", "gpu_user_annotation", t + 100, UPLOAD_US))
        events.append(_event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t + 100, UPLOAD_US))
        start = t + 1_000
        events.append(_event("backbone", "gpu_user_annotation", start, BLOCKS * 1_000))
        for b in range(BLOCKS):
            if spans:
                events.append(_event("window_attention", "gpu_user_annotation", start, KERNEL_A_US))
            events += [_event("window_attention_mma_kernel<144, 32, true>", "kernel", start, KERNEL_A_US),
                       _event("void gemm", "kernel", start + 100, GEMM_US)]
            start += 1_000
        if request_on_device:
            events.append(_event("request", "gpu_user_annotation", t + 100, start - t - 100))
        events.append(_event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t + 9_000, DOWNLOAD_US))
    return SimpleNamespace(trace=Trace(events), units=requests, window_s=requests * 0.01, unprofiled_s=0.01, batch=1,
                           height=1024, width=2048, config={}, traffic={})


def _read(metric, r):
    return run.layer_reader(run.Cell("swin_b_1dl.camera", 1, {}, {}, []), metric)(r)


@pytest.mark.parametrize("request_on_device", [False, True])
@pytest.mark.parametrize("requests", [1, 3])
def test_span_readers_per_request(requests, request_on_device):
    r = _synthetic_run(requests, request_on_device)
    # the copy and each (Kernel A, GEMM) pair; the download starts outside every span
    assert _read("launches_per_request.serve", r) == 1 + 2 * BLOCKS
    assert _read("upload_busy_ms.serve", r) == pytest.approx(UPLOAD_US / 1e3)
    assert _read("window_attention_busy_ms.serve", r) == pytest.approx(BLOCKS * KERNEL_A_US / 1e3)


def test_span_readers_read_none_without_their_spans():
    r = _synthetic_run(spans=False)
    for metric in ("launches_per_request.serve", "upload_busy_ms.serve", "window_attention_busy_ms.serve"):
        assert _read(metric, r) is None
    # the accepted readers still read the same trace
    assert _read("backbone_busy_ms.serve", r) == pytest.approx(BLOCKS * (KERNEL_A_US + GEMM_US) / 1e3)


def test_operations_outside_the_spans_are_not_counted():
    """Operations before the upload's span, between the request's spans and after them
    are left out; one that starts inside a span and ends after it is counted whole."""
    r = _synthetic_run(1)
    extra = [_event("stray memset", "gpu_memset", 50, 20), _event("stray kernel", "kernel", 600, 100),
             _event("late kernel", "kernel", 9_500, 100), _event("long copy", "gpu_memcpy", 150, 1_000)]
    events = [_event(n, "gpu_user_annotation", a, b - a) for n, spans in r.trace.device_spans.items() for a, b in spans]
    events += [_event(n, "user_annotation", a, b - a) for n, spans in r.trace.host_spans.items() for a, b in spans]
    events += [_event(n, "kernel", a, b - a) for a, b, n in r.trace.device] + extra
    r.trace = Trace(events)
    assert _read("launches_per_request.serve", r) == 1 + 2 * BLOCKS + 1
    assert _read("upload_busy_ms.serve", r) == pytest.approx((UPLOAD_US + 1_000) / 1e3)
    assert _read("window_attention_busy_ms.serve", r) == pytest.approx(BLOCKS * KERNEL_A_US / 1e3)
