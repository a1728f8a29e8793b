"""MiT's forward replayed as CUDA graphs split at Kernel G, against its eager forward, on
the card.

``models/mix_transformer.py`` ``mit_apply`` replays the stretches between the attention
cores as CUDA graphs (``models/cuda_graphs.py``) where ``graphs_take`` says so: the first
call of a shape runs eagerly, the second captures, later ones replay, with Kernel G
launched eagerly between the stretches.  Marked ``cuda``: each test skips where no CUDA
GPU is present (tests/test_torch_sr_attention.py holds the rule, the generator forward
and the cache's bookkeeping on the CPU).  On a machine with an H100:
``python -m pytest tests/test_torch_mit_graphs_cuda.py -q``.
"""
import pytest
import torch

from rba_tpu_torch.kernels import sr_attention as tsa
from rba_tpu_torch.models import cuda_graphs
from rba_tpu_torch.models import mix_transformer as tmit

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _model(variant: str, device, seed: int = 0) -> tmit.MiT:
    torch.manual_seed(seed)
    return tmit.MiT(tmit.MIT_VARIANTS[variant]).to(device)


def _images(shape, device, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, 3, generator=gen, device=device)


def _eager(model, images, monkeypatch):
    """The eager forward with Kernel G: the graph rule answers no inside."""
    with monkeypatch.context() as m:
        m.setattr(tmit, "graphs_take", lambda *args: False)
        return tmit.mit_apply(model, images)


def _equal(got, want) -> bool:
    return got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("variant,shape", [("mit_b0", (2, 64, 96)), ("mit_b5", (1, 1024, 2048))],
                         ids=["b0_64x96_B2", "b5_1024x2048"])
def test_replay_is_bit_equal_to_the_eager_forward(cuda, variant, shape, monkeypatch):
    """Warm-up, capture and two replays of alternating inputs each equal the eager
    Kernel G forward bit for bit; one capture for the shape, blocks + 1 replays and one
    Kernel G launch a block per call."""
    model = _model(variant, cuda)
    blocks = sum(model.cfg.depths)
    xs = [_images(shape, cuda, seed) for seed in (1, 2)]
    with torch.inference_mode():
        want = [_eager(model, x, monkeypatch) for x in xs]
        captures, replays, launches = cuda_graphs.piecewise.captures, cuda_graphs.piecewise.replays, \
            tsa.sr_attention.launches
        got = [tmit.mit_apply(model, xs[i % 2]) for i in range(4)]  # eager, capture, replay, replay
    torch.cuda.synchronize()
    assert all(_equal(g, want[i % 2]) for i, g in enumerate(got))
    assert cuda_graphs.piecewise.captures == captures + 1
    assert cuda_graphs.piecewise.replays == replays + 3 * (blocks + 1)
    assert tsa.sr_attention.launches == launches + 4 * blocks


def test_weights_loaded_in_place_show_in_the_next_replay(cuda, monkeypatch):
    """``load_state_dict`` copies into the weights the graphs read: the next replay uses
    the new weights, without a new capture."""
    model, other = _model("mit_b0", cuda, seed=0), _model("mit_b0", cuda, seed=1)
    x = _images((1, 64, 96), cuda, 3)
    with torch.inference_mode():
        for _ in range(3):
            before = tmit.mit_apply(model, x)
    captures = cuda_graphs.piecewise.captures
    model.load_state_dict(other.state_dict())
    with torch.inference_mode():
        got = tmit.mit_apply(model, x)
        want = _eager(other, x, monkeypatch)
    assert cuda_graphs.piecewise.captures == captures
    assert _equal(got, want) and not torch.equal(got["res5"], before["res5"])


def test_weights_moved_are_captured_anew(cuda, monkeypatch):
    """A weight given new memory (``.data =``) is seen: the next call captures again, and
    its maps are the new weights'."""
    model = _model("mit_b0", cuda)
    x = _images((1, 64, 96), cuda, 4)
    with torch.inference_mode():
        for _ in range(3):
            tmit.mit_apply(model, x)
    captures = cuda_graphs.piecewise.captures
    norm = model.stages[3].norm
    norm.weight.data = norm.weight.data * 2
    with torch.inference_mode():
        got = tmit.mit_apply(model, x)
        want = _eager(model, x, monkeypatch)
    assert cuda_graphs.piecewise.captures == captures + 1 and _equal(got, want)


def test_maps_survive_the_next_replay(cuda):
    """The maps returned by call n are copies: call n + 1 on another input leaves them as
    they were."""
    model = _model("mit_b0", cuda)
    xs = [_images((1, 64, 96), cuda, seed) for seed in (5, 6)]
    with torch.inference_mode():
        tmit.mit_apply(model, xs[0])
        tmit.mit_apply(model, xs[0])  # captured
        first = tmit.mit_apply(model, xs[0])
        kept = {k: v.clone() for k, v in first.items()}
        second = tmit.mit_apply(model, xs[1])
    assert _equal(first, kept) and not torch.equal(second["res2"], first["res2"])


def test_cache_bound_holds(cuda):
    """Past ``MAX_SHAPES`` shapes the least recently used capture goes: each of
    ``MAX_SHAPES`` + 1 shapes captures once, and a model keeps ``MAX_SHAPES``."""
    model = _model("mit_b0", cuda)
    shapes = [(1, 64, 64 + 32 * i) for i in range(cuda_graphs.MAX_SHAPES + 1)]
    captures = cuda_graphs.piecewise.captures
    with torch.inference_mode():
        for shape in shapes:
            x = _images(shape, cuda, 7)
            for _ in range(3):
                tmit.mit_apply(model, x)
    assert cuda_graphs.piecewise.captures == captures + len(shapes)
    assert len(cuda_graphs._CACHE[model]) == cuda_graphs.MAX_SHAPES


def test_nothing_is_captured_under_autograd(cuda):
    """With autograd on the forward runs eagerly, whether or not the input needs a
    gradient, and captures nothing."""
    model = _model("mit_b0", cuda)
    x = _images((1, 64, 96), cuda, 8)
    captures, replays = cuda_graphs.piecewise.captures, cuda_graphs.piecewise.replays
    for _ in range(3):
        tmit.mit_apply(model, x)
        tmit.mit_apply(model, x.clone().requires_grad_())
    assert (cuda_graphs.piecewise.captures, cuda_graphs.piecewise.replays) == (captures, replays)
    assert model not in cuda_graphs._CACHE
