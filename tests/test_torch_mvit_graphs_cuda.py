"""MViTv2-B's forward replayed as CUDA graphs split at its spans, against its eager
forward, on the card.

``models/mvit.py`` ``mvit_apply`` replays the forward as CUDA graphs
(``models/cuda_graphs.py`` ``spanwise``) where ``graphs_take`` says so: the first call of
a shape runs eagerly, the second captures, later ones replay, each ``qkv_pool`` and
``rel_pos_attention`` span's graph inside its span.  Marked ``cuda``: each test skips
where no CUDA GPU is present (tests/test_torch_spanwise.py holds the rule, the split and
the cache's bookkeeping on the CPU).  On a machine with an H100:
``python -m pytest tests/test_torch_mvit_graphs_cuda.py -q``.
"""
import json

import pytest
import torch
from torch import nn

from rba_tpu_torch.kernels import rel_pos_attention as trp
from rba_tpu_torch.models import cuda_graphs
from rba_tpu_torch.models import mvit as tmvit
from rba_tpu_torch.utils import profiling as tprof

pytestmark = pytest.mark.cuda

BLOCKS = 24
GRAPHS = 4 * BLOCKS + 1  # a graph per span, two spans a block, and one per stretch around them


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _model(device, seed: int = 0) -> tmvit.MViT:
    """MViTv2-B at its published widths, weights of std 0.02 (the tables' zeros would hide
    the position terms)."""
    torch.manual_seed(seed)
    model = tmvit.MViT(tmvit.MViTConfig()).to(device).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(std=0.02)
    return model


def _images(shape, device, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, 3, generator=gen, device=device)


def _eager(model, images, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(tmvit, "graphs_take", lambda *args: False)
        return tmvit.mvit_apply(model, images)


def _equal(got, want) -> bool:
    return got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 1024, 2048)], ids=["64x128_B2", "1024x2048"])
def test_replay_is_bit_equal_to_the_eager_forward(cuda, shape, monkeypatch):
    """Warm-up, capture and two replays of alternating inputs each equal the eager
    forward bit for bit; one capture for the shape and ``GRAPHS`` replays a call."""
    model = _model(cuda)
    xs = [_images(shape, cuda, seed) for seed in (1, 2)]
    with torch.inference_mode():
        want = [_eager(model, x, monkeypatch) for x in xs]
        captures, replays = cuda_graphs.spanwise.captures, cuda_graphs.spanwise.replays
        got = [tmvit.mvit_apply(model, xs[i % 2]) for i in range(4)]  # eager, capture, replay, replay
    torch.cuda.synchronize()
    assert all(_equal(g, want[i % 2]) for i, g in enumerate(got))
    assert cuda_graphs.spanwise.captures == captures + 1
    assert cuda_graphs.spanwise.replays == replays + 3 * GRAPHS


def test_replayed_spans_hold_their_kernels_on_the_device(cuda, tmp_path):
    """A profiled replay opens one ``qkv_pool`` and one ``rel_pos_attention`` span per
    block on the host, and the profiler mirrors each on the device: the span's graph's
    kernels are the span's."""
    from torch.profiler import ProfilerActivity, profile

    model = _model(cuda)
    x = _images((1, 128, 256), cuda, 3)
    with torch.inference_mode():
        for _ in range(2):
            tmvit.mvit_apply(model, x)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tmvit.mvit_apply(model, x)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    for cat in ("user_annotation", "gpu_user_annotation"):
        names = [e["name"] for e in events if e.get("cat") == cat]
        assert names.count(tprof.QKV_POOL) == names.count(tprof.REL_POS_ATTENTION) == BLOCKS, cat


def test_weights_loaded_in_place_show_in_the_next_replay(cuda, monkeypatch):
    model, other = _model(cuda, seed=0), _model(cuda, seed=1)
    x = _images((1, 64, 128), cuda, 4)
    with torch.inference_mode():
        for _ in range(3):
            before = tmvit.mvit_apply(model, x)
    captures = cuda_graphs.spanwise.captures
    model.load_state_dict(other.state_dict())
    with torch.inference_mode():
        got = tmvit.mvit_apply(model, x)
        want = _eager(other, x, monkeypatch)
    assert cuda_graphs.spanwise.captures == captures
    assert _equal(got, want) and not torch.equal(got["scale5"], before["scale5"])


def test_weights_moved_are_captured_anew(cuda, monkeypatch):
    model = _model(cuda)
    x = _images((1, 64, 128), cuda, 5)
    with torch.inference_mode():
        for _ in range(3):
            tmvit.mvit_apply(model, x)
    captures = cuda_graphs.spanwise.captures
    norm = model.scale5_norm
    norm.weight.data = norm.weight.data * 2
    with torch.inference_mode():
        got = tmvit.mvit_apply(model, x)
        want = _eager(model, x, monkeypatch)
    assert cuda_graphs.spanwise.captures == captures + 1 and _equal(got, want)


def test_nothing_is_captured_under_autograd(cuda):
    model = _model(cuda)
    x = _images((1, 64, 128), cuda, 6)
    captures, replays = cuda_graphs.spanwise.captures, cuda_graphs.spanwise.replays
    for _ in range(3):
        tmvit.mvit_apply(model, x)
    assert (cuda_graphs.spanwise.captures, cuda_graphs.spanwise.replays) == (captures, replays)
    assert model not in cuda_graphs._CACHE


def test_kernel_h_takes_every_core_and_replays_launch_nothing(cuda, monkeypatch):
    """At 1024x2048 Kernel H and its tables kernel take each block's core: 24 launches of
    each an eager image and 24 at the capture, and the replays, 97 graphs a call, add no
    eager launch and stay bit-equal to the eager forward."""
    model = _model(cuda)
    x = _images((1, 1024, 2048), cuda, 7)
    launches, tables = [], []
    with torch.inference_mode():
        before, before_tables = trp.rel_pos_attention.launches, trp.rel_pos_tables.launches
        want = _eager(model, x, monkeypatch)
        launches.append(trp.rel_pos_attention.launches - before)
        tables.append(trp.rel_pos_tables.launches - before_tables)
        replays = cuda_graphs.spanwise.replays
        for _ in range(4):  # eager, capture, replay, replay
            before, before_tables = trp.rel_pos_attention.launches, trp.rel_pos_tables.launches
            got = tmvit.mvit_apply(model, x)
            launches.append(trp.rel_pos_attention.launches - before)
            tables.append(trp.rel_pos_tables.launches - before_tables)
            assert _equal(got, want)
    assert launches == tables == [BLOCKS, BLOCKS, BLOCKS, 0, 0]
    assert cuda_graphs.spanwise.replays == replays + 3 * GRAPHS


def test_each_rel_pos_span_holds_kernel_h_on_the_device(cuda, tmp_path):
    """In a profiled replay of a 1024x2048 request, each of the 24 ``rel_pos_attention``
    device spans holds one Kernel H launch and one of its tables kernel, and no other span
    holds one."""
    from torch.profiler import ProfilerActivity, profile

    model = _model(cuda)
    x = _images((1, 1024, 2048), cuda, 8)
    with torch.inference_mode():
        for _ in range(2):
            tmvit.mvit_apply(model, x)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tmvit.mvit_apply(model, x)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "gpu_user_annotation" and e["name"] == tprof.REL_POS_ATTENTION]
    for symbol in ("rel_pos_attention_kernel", "rel_pos_tables_kernel"):
        kernels = [e for e in events if e.get("cat") == "kernel" and symbol in e["name"]]
        assert len(spans) == len(kernels) == BLOCKS, symbol
        inside = [sum(sp["ts"] <= k["ts"] < sp["ts"] + sp["dur"] for k in kernels) for sp in spans]
        assert inside == [1] * BLOCKS, symbol
