"""CUDA graphs split at a forward's spans (``rba_tpu_torch/models/cuda_graphs.py``
``spanwise``) and MViT's rule for them (``models/mvit.py`` ``graphs_take``), on the CPU.

Nothing is captured here: the split is held with its graphs stood in for by a log, and
the cache's bookkeeping with a capture that runs the forward eagerly.  The card holds the
replay against the eager forward (tests/test_torch_mvit_graphs_cuda.py)."""
from __future__ import annotations

import contextlib

import pytest
import torch
from torch import nn

from rba_tpu_torch.models import cuda_graphs
from rba_tpu_torch.models import mvit as tmvit
from rba_tpu_torch.utils import profiling as tprof

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("device,grad,want", [(CUDA, False, True), (CPU, False, False), (CUDA, True, False)],
                         ids=["cuda", "cpu", "grad"])
def test_graphs_take(device, grad, want):
    """Graphs engage on CUDA with autograd off; the CPU and training stay eager."""
    assert tmvit.graphs_take(device, grad) is want


class _LoggedSpans(cuda_graphs._Spans):
    """``_Spans`` with its graphs stood in for: ``_begin`` and ``_end`` log the graph
    they would start and end."""

    def __init__(self):
        self.graphs, self._inside, self.log = [], False, []

    def _begin(self, name):
        self.graphs.append((name, None))
        self.log.append(("begin", name))

    def _end(self):
        self.log.append(("end", self.graphs[-1][0]))


def _two_spans(x):
    y = x + 1
    with tprof.span(tprof.QKV_POOL):
        y = y * 2
    with tprof.span(tprof.REL_POS_ATTENTION):
        y = y - 3
    return {"out": y}


def test_split_gives_each_span_a_graph_of_its_own():
    """Under ``splitting``, each span ends the graph being captured and its block is a
    graph of its own; the stretches between spans are graphs too, and the forward
    computes what it computes eagerly."""
    spans = _LoggedSpans()
    x = torch.arange(3.0)
    spans._begin(None)
    with tprof.splitting(spans._split):
        got = _two_spans(x)
    spans._end()
    assert torch.equal(got["out"], _two_spans(x)["out"])
    assert [name for name, _ in spans.graphs] == [None, tprof.QKV_POOL, None, tprof.REL_POS_ATTENTION, None]
    assert spans.log == [("begin", None), ("end", None), ("begin", tprof.QKV_POOL), ("end", tprof.QKV_POOL),
                         ("begin", None), ("end", None), ("begin", tprof.REL_POS_ATTENTION),
                         ("end", tprof.REL_POS_ATTENTION), ("begin", None), ("end", None)]


def test_split_refuses_a_span_inside_a_span():
    spans = _LoggedSpans()
    spans._begin(None)
    with tprof.splitting(spans._split), pytest.raises(RuntimeError, match="inside another span"):
        with tprof.span(tprof.QKV_POOL):
            with tprof.span(tprof.REL_POS_ATTENTION):
                pass
    assert not spans._inside  # the outer span's exit ran


def test_splitting_ends_with_its_block():
    """Outside ``splitting`` a span is the profiler's again: no-op without a profiler."""
    seen = []
    with tprof.splitting(lambda name: seen.append(name) or contextlib.nullcontext()):
        with tprof.span(tprof.QKV_POOL):
            pass
    assert seen == [tprof.QKV_POOL]
    assert tprof.span(tprof.QKV_POOL) is tprof._OFF


@pytest.fixture(scope="module")
def mvit_small():
    """MViTv2-B at its published widths, fp32 weights of std 0.02, and one 64x128 input."""
    torch.manual_seed(0)
    model = tmvit.MViT(tmvit.MViTConfig()).eval()
    for p in model.parameters():
        nn.init.normal_(p, std=0.02)
    images = torch.randn(1, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    return model, images


def test_mvit_forward_splits_at_its_24_pools_and_24_cores(mvit_small):
    """MViTv2-B's forward hands the capture one ``qkv_pool`` and then one
    ``rel_pos_attention`` span per block, none inside another, and computes its eager
    maps bit for bit."""
    model, images = mvit_small
    spans = _LoggedSpans()
    with torch.inference_mode():
        want = tmvit._forward(model, images, torch.float32)
        spans._begin(None)
        with tprof.splitting(spans._split):
            got = tmvit._forward(model, images, torch.float32)
        spans._end()
    named = [name for name, _ in spans.graphs if name is not None]
    assert named == [tprof.QKV_POOL, tprof.REL_POS_ATTENTION] * 24
    assert len(spans.graphs) == 2 * 48 + 1
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_mvit_apply_on_the_cpu_captures_nothing(mvit_small):
    model, images = mvit_small
    with torch.inference_mode():
        got = [tmvit.mvit_apply(model, images, torch.float32) for _ in range(3)]
        want = tmvit._forward(model, images, torch.float32)
    assert all(torch.equal(g[k], want[k]) for g in got for k in want)
    assert model not in cuda_graphs._CACHE


class _EagerSpans(cuda_graphs._Spans):
    """Stands in for a capture on the CPU: runs the forward eagerly at "capture" and at
    each "replay", and keeps the weights' places as a capture does."""

    log = []

    def __init__(self, module, forward, x):
        cuda_graphs._Captured.__init__(self, module, x)
        self.forward, self.outs = forward, forward(x)
        self.log.append(("capture", tuple(x.shape)))

    def replay(self, x, call):
        assert call is None
        self.outs = self.forward(x)
        self.log.append(("replay", tuple(x.shape)))


@pytest.fixture
def eager_spans(monkeypatch):
    monkeypatch.setattr(cuda_graphs, "_Spans", _EagerSpans)
    _EagerSpans.log = []
    return _EagerSpans.log


def test_spanwise_warms_up_then_captures_then_replays(eager_spans):
    """The first call of a key runs eagerly, the second captures, later ones replay; the
    outputs equal the eager forward's, and copies of them are returned; without a key
    the forward runs eagerly and leaves the captures alone."""
    module = nn.Linear(2, 2)
    x = torch.arange(4.0)
    want = _two_spans(x)
    for _ in range(4):
        got = cuda_graphs.spanwise(module, _two_spans, x, key="k")
        assert torch.equal(got["out"], want["out"])
    assert eager_spans == [("capture", (4,)), ("replay", (4,)), ("replay", (4,))]
    first = cuda_graphs.spanwise(module, _two_spans, x, key="k")
    again = cuda_graphs.spanwise(module, _two_spans, x + 1, key="k")
    assert torch.equal(first["out"], want["out"]) and not torch.equal(again["out"], want["out"])
    assert torch.equal(cuda_graphs.spanwise(module, _two_spans, x)["out"], want["out"])
    assert len(eager_spans) == 5


def test_spanwise_cache_bound_and_moved_weights(eager_spans):
    """At most ``MAX_SHAPES`` keys per module, the least recently used dropped first; a
    weight copied into in place keeps the capture, a weight moved to other memory makes a
    new one."""
    module = nn.Linear(2, 2)
    shapes = [(n,) for n in range(1, cuda_graphs.MAX_SHAPES + 2)]
    for shape in shapes:
        for _ in range(2):
            cuda_graphs.spanwise(module, _two_spans, torch.zeros(shape), key="k")
    seen = cuda_graphs._CACHE[module]
    assert len(seen) == cuda_graphs.MAX_SHAPES and [k[0] for k in seen] == shapes[1:]
    assert eager_spans == [("capture", s) for s in shapes]
    last = torch.zeros(shapes[-1])
    with torch.no_grad():
        module.weight.copy_(torch.ones(2, 2))
    cuda_graphs.spanwise(module, _two_spans, last, key="k")
    assert eager_spans[-1] == ("replay", shapes[-1])
    module.weight.data = module.weight.data.clone()
    cuda_graphs.spanwise(module, _two_spans, last, key="k")
    assert eager_spans[-1] == ("capture", shapes[-1])
