"""Kernel G's route and its wrapper's argument checks, and MiT's plain attention core, on
the CPU.

``kernels/sr_attention.py`` ``takes`` decides from what a call can observe whether a
block's attention core (``models/mix_transformer.py``) runs Kernel G or the plain chain
``sr_attention_plain``; the wrapper checks its arguments before it looks at
the device, so CPU tensors reach every check without a launch.  The kernel itself is
held against the plain chain on the card (tests/test_torch_kernels_cuda.py).
"""
import contextlib

import numpy as np
import pytest
import torch
from torch import nn

from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.kernels import sr_attention as tsa
from rba_tpu_torch.models import cuda_graphs
from rba_tpu_torch.models import mix_transformer as tmit
from rba_tpu_torch.models.vit import scaled

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device,dtype,needs_grad,head_dim,want", [
    (CUDA, torch.bfloat16, False, 64, True),  # MiT-B1…B5 serving
    (CUDA, torch.bfloat16, False, 32, True),  # MiT-B0
    (CPU, torch.bfloat16, False, 64, False),
    (CUDA, torch.bfloat16, True, 64, False),  # training: the gradient is the plain chain's
    (CUDA, torch.float32, False, 64, False),
    (CUDA, torch.float16, False, 64, False),
    (CUDA, torch.bfloat16, False, 48, False),
], ids=["cuda_hd64", "cuda_hd32", "cpu", "grad", "fp32", "fp16", "hd48"])
def test_takes_kernel(device, dtype, needs_grad, head_dim, want):
    assert tsa.takes(device, dtype, needs_grad, head_dim) is want


def _inputs(b=2, heads=2, n=20, m=7, hd=64, dtype=torch.bfloat16, seed=0):
    rs = np.random.default_rng(seed)
    q = torch.tensor(rs.standard_normal((b, n, heads * hd)), dtype=torch.float32).to(dtype)
    kv = torch.tensor(rs.standard_normal((b, m, 2 * heads * hd)), dtype=torch.float32).to(dtype)
    return q, kv, heads


def _bad_dtype():
    q, kv, heads = _inputs()
    return q.float(), kv.float(), heads


def _kv_width():
    q, kv, heads = _inputs()
    return q, kv[:, :, :-64], heads


def _batch_mismatch():
    q, kv, heads = _inputs()
    return q, kv[:1], heads


def _two_dims():
    q, kv, heads = _inputs()
    return q[0], kv[0], heads


def _head_dim_48():
    return _inputs(heads=2, hd=48)


def _empty():
    q, kv, heads = _inputs()
    return q[:, :0], kv, heads


def _non_contiguous():
    q, kv, heads = _inputs()
    return q.transpose(0, 1).contiguous().transpose(0, 1), kv, heads


def _misaligned():
    q, kv, heads = _inputs()
    shifted = torch.empty(kv.numel() + 1, dtype=kv.dtype)[1:].view(kv.shape)  # 2 bytes past the allocation
    return q, shifted.copy_(kv), heads


def _cpu():
    return _inputs()


def _out_shape():
    q, kv, heads = _inputs()
    return q, kv, heads, torch.empty_like(q[:, 1:])


def _out_dtype():
    q, kv, heads = _inputs()
    return q, kv, heads, torch.empty_like(q, dtype=torch.float32)


def _out_non_contiguous():
    q, kv, heads = _inputs()
    return q, kv, heads, torch.empty_like(q).transpose(0, 1).contiguous().transpose(0, 1)


def _out_misaligned():
    q, kv, heads = _inputs()
    return q, kv, heads, torch.empty(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)


def _out_cpu():
    q, kv, heads = _inputs()
    return q, kv, heads, torch.empty_like(q)


@pytest.mark.parametrize("make,error,match", [
    (_bad_dtype, TypeError, "bfloat16"),
    (_kv_width, ValueError, "does not match"),
    (_batch_mismatch, ValueError, "does not match"),
    (_two_dims, ValueError, r"\(B, N, C\)"),
    (_head_dim_48, ValueError, "head dims"),
    (_empty, ValueError, "empty"),
    (_non_contiguous, ValueError, "contiguous"),
    (_misaligned, ValueError, "16 bytes"),
    (_cpu, ValueError, "cuda device"),
    (_out_shape, ValueError, "out must be"),
    (_out_dtype, ValueError, "out must be"),
    (_out_non_contiguous, ValueError, "out must be"),
    (_out_misaligned, ValueError, "out must be"),
    (_out_cpu, ValueError, "cuda device"),
], ids=["dtype", "kv_width", "batch", "dims", "head_dim", "empty", "contiguity", "alignment", "cpu", "out_shape",
        "out_dtype", "out_contiguity", "out_alignment", "out_cpu"])
def test_wrapper_checks_raise_without_a_launch(make, error, match):
    before = tsa.sr_attention.launches
    with pytest.raises(error, match=match):
        tsa.sr_attention(*make())
    assert tsa.sr_attention.launches == before


def _inline_core(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The core as ``_attention`` computed it inline before ``sr_attention_plain``: the
    linears' outputs split into heads, the chain, and the heads merged for ``proj``."""
    b, n, c = q.shape
    hd = c // num_heads
    q = q.reshape(b, n, num_heads, hd).transpose(1, 2)
    k, v = kv.reshape(b, -1, 2, num_heads, hd).permute(2, 0, 3, 1, 4)
    attn = scaled(torch.matmul(q, k.transpose(-1, -2)), hd**-0.5)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    out = torch.matmul(attn, v)
    return out.transpose(1, 2).reshape(b, n, c)


def _stage_shapes(variant: str, hw=(64, 96)):
    """(heads, N, M, head dim) of each stage of a MiT variant on an hw frame."""
    cfg = tmit.MIT_VARIANTS[variant]
    h, w = hw
    out = []
    for s, (k, stride) in enumerate(tmit.PATCH):
        h, w = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
        sr = cfg.sr_ratios[s]
        out.append((cfg.num_heads[s], h * w, (h // sr) * (w // sr), cfg.embed_dims[s] // cfg.num_heads[s]))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["mit_b0", "mit_b5"])
def test_plain_equals_the_inline_core(variant, dtype):
    """``sr_attention_plain`` equals the core ``_attention`` computed inline, bit for bit,
    at each stage shape of a small frame, batch 2."""
    for i, (heads, n, m, hd) in enumerate(_stage_shapes(variant)):
        q, kv, _ = _inputs(b=2, heads=heads, n=n, m=m, hd=hd, dtype=dtype, seed=i)
        assert torch.equal(tmit.sr_attention_plain(q, kv, heads), _inline_core(q, kv, heads))


def _small_mit(variant: str):
    torch.manual_seed(0)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 64, 96, 3)).astype(np.float32))
    return tmit.MiT(tmit.MIT_VARIANTS[variant]), images


@pytest.fixture(scope="module")
def mit_b0():
    return _small_mit("mit_b0")


def _inline_mit_apply(model, images, compute_dtype):
    """The MiT forward as ``mit_apply`` computed it inline, before it was a generator that
    stops at each attention core: one function, the core in the middle of each block."""
    from rba_tpu_torch.models.swin import gelu
    from rba_tpu_torch.ops.nn import apply_conv, apply_linear, centered_layer_norm

    cfg = model.cfg
    x = images.to(compute_dtype)
    outs = {}
    for s, stage in enumerate(model.stages):
        k, stride = tmit.PATCH[s]
        x = apply_conv(stage["patch_embed"]["proj"], x, stride=stride, padding=k // 2)
        b, h, w, dim = x.shape
        x = centered_layer_norm(x.reshape(b, h * w, dim), stage["patch_embed"]["norm"])
        heads, sr = cfg.num_heads[s], cfg.sr_ratios[s]
        for blk in stage["blocks"]:
            p, y = blk.attn, centered_layer_norm(x, blk.norm1)
            q, kv_in = apply_linear(p["q"], y), y
            if sr > 1:
                ys = apply_conv(p["sr"], y.reshape(b, h, w, dim), stride=sr, padding="VALID")
                kv_in = centered_layer_norm(ys.reshape(b, -1, dim), p["sr_norm"])
            x = x + apply_linear(p["proj"], _inline_core(q, apply_linear(p["kv"], kv_in), heads))
            y = apply_linear(blk.mlp["fc1"], centered_layer_norm(x, blk.norm2))
            hidden = y.shape[-1]
            y = apply_conv(blk.mlp["dwconv"], y.reshape(b, h, w, hidden), padding=1, groups=hidden)
            x = x + apply_linear(blk.mlp["fc2"], gelu(y.reshape(b, h * w, hidden)))
        x = centered_layer_norm(x, stage["norm"]).reshape(b, h, w, dim)
        outs[f"res{s + 2}"] = x
    return outs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["mit_b0", "mit_b1"])
def test_mit_apply_on_the_cpu_never_reaches_the_kernel(variant, dtype, monkeypatch):
    """On the CPU the forward, a generator stopping at each attention core and driven
    eagerly, equals the inline forward bit for bit (every stage, its transition, and
    ``sr`` 8 down to 1), never calls Kernel G and captures nothing."""
    model, images = _small_mit(variant)
    monkeypatch.setattr(tsa, "sr_attention", lambda *args, **kw: pytest.fail("Kernel G was called on the CPU"))
    with torch.no_grad():
        outs = tmit.mit_apply(model, images, dtype)
        want = _inline_mit_apply(model, images, dtype)
    assert all(x.dtype == dtype for x in outs.values())
    assert outs.keys() == want.keys() and all(torch.equal(outs[k], want[k]) for k in want)
    assert model not in cuda_graphs._CACHE


B5 = tmit.MIT_VARIANTS["mit_b5"]


@pytest.mark.parametrize("cfg,device,dtype,grad,plain,want", [
    (B5, CUDA, torch.bfloat16, False, False, True),  # MiT-B5 serving
    (tmit.MIT_VARIANTS["mit_b0"], CUDA, torch.bfloat16, False, False, True),  # head dim 32
    (B5, CPU, torch.bfloat16, False, False, False),
    (B5, CUDA, torch.bfloat16, True, False, False),  # autograd on: training
    (B5, CUDA, torch.float32, False, False, False),
    (B5, CUDA, torch.bfloat16, False, True, False),  # plain_versions()
    (tmit.MiTConfig(embed_dims=(64, 128, 320, 480)), CUDA, torch.bfloat16, False, False, False),  # one head dim 60
], ids=["b5", "b0_hd32", "cpu", "grad", "fp32", "plain", "hd60"])
def test_graphs_take(cfg, device, dtype, grad, plain, want):
    """Graphs engage where the forward's input is on CUDA, autograd is off and Kernel G
    takes every block's core; one block it does not take keeps the whole forward eager."""
    with plain_versions() if plain else contextlib.nullcontext():
        assert tmit.graphs_take(cfg, device, dtype, grad) is want


class _EagerPieces(cuda_graphs._Pieces):
    """Stands in for a capture on the CPU: runs the forward eagerly at "capture" and at
    each "replay", and keeps the weights' places as a capture does."""

    log = []

    def __init__(self, module, forward, x, call):
        self.weights = [*module.parameters(), *module.buffers()]
        self.ptrs, self.forward = self._ptrs(), forward
        self.outs = cuda_graphs._drive(forward(x), call)
        self.log.append(("capture", tuple(x.shape)))

    def replay(self, x, call):
        self.outs = cuda_graphs._drive(self.forward(x), call)
        self.log.append(("replay", tuple(x.shape)))


@pytest.fixture
def eager_pieces(monkeypatch):
    monkeypatch.setattr(cuda_graphs, "_Pieces", _EagerPieces)
    _EagerPieces.log = []
    return _EagerPieces.log


def _doubling(x):
    """A forward with one eager call: y = 2x is yielded, the call adds 1."""
    y = yield (x * 2,)
    return {"out": y * 3}


def test_piecewise_warms_up_then_captures_then_replays(eager_pieces):
    """The first call of a key runs eagerly, the second captures, later ones replay; the
    outputs equal the eager forward's, and copies of them are returned."""
    module = nn.Linear(2, 2)
    call = lambda y, out=None: y + 1  # noqa: E731
    x = torch.arange(4.0)
    want = {"out": (x * 2 + 1) * 3}
    for _ in range(4):
        got = cuda_graphs.piecewise(module, _doubling, x, call, key="k")
        assert torch.equal(got["out"], want["out"])
    assert eager_pieces == [("capture", (4,)), ("replay", (4,)), ("replay", (4,))]
    first = cuda_graphs.piecewise(module, _doubling, x, call, key="k")
    again = cuda_graphs.piecewise(module, _doubling, x + 1, call, key="k")
    assert torch.equal(first["out"], want["out"]) and not torch.equal(again["out"], want["out"])
    assert torch.equal(cuda_graphs.piecewise(module, _doubling, x, call)["out"], want["out"])
    assert len(eager_pieces) == 5  # without a key the call runs eagerly and leaves the captures alone


def test_piecewise_cache_bound_and_moved_weights(eager_pieces):
    """At most ``MAX_SHAPES`` keys per module, the least recently used dropped first; a
    weight copied into in place keeps the capture, a weight moved to other memory makes a
    new one."""
    module = nn.Linear(2, 2)
    call = lambda y, out=None: y + 1  # noqa: E731
    shapes = [(n,) for n in range(1, cuda_graphs.MAX_SHAPES + 2)]
    for shape in shapes:
        for _ in range(2):
            cuda_graphs.piecewise(module, _doubling, torch.zeros(shape), call, key="k")
    seen = cuda_graphs._CACHE[module]
    assert len(seen) == cuda_graphs.MAX_SHAPES and [k[0] for k in seen] == shapes[1:]
    assert eager_pieces == [("capture", s) for s in shapes]
    last = torch.zeros(shapes[-1])
    with torch.no_grad():
        module.weight.copy_(torch.ones(2, 2))
    cuda_graphs.piecewise(module, _doubling, last, call, key="k")
    assert eager_pieces[-1] == ("replay", shapes[-1])
    module.weight.data = module.weight.data.clone()
    cuda_graphs.piecewise(module, _doubling, last, call, key="k")
    assert eager_pieces[-1] == ("capture", shapes[-1])


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_mit_apply_launches_once_per_block_where_the_rule_says_so(mit_b0, plain, monkeypatch):
    """Where ``takes`` says so, each block's core goes to the wrapper once, with the
    linears' outputs as they are (contiguous) and the block's heads; ``plain_versions()``
    keeps every core on the plain chain.  The rule answers as on the card, and the
    wrapper is stood in for by the plain chain."""
    model, images = mit_b0
    calls = []

    def fake(q, kv, heads, out=None):
        calls.append((q.is_contiguous() and kv.is_contiguous(), heads))
        return tmit.sr_attention_plain(q, kv, heads)

    with torch.no_grad():
        want = tmit.mit_apply(model, images)
    real = tsa.takes
    monkeypatch.setattr(tsa, "takes", lambda device, *args: real(CUDA, *args))
    monkeypatch.setattr(tsa, "sr_attention", fake)
    with torch.no_grad(), plain_versions() if plain else contextlib.nullcontext():
        got = tmit.mit_apply(model, images)
    cfg = tmit.MIT_VARIANTS["mit_b0"]
    assert calls == ([] if plain else [(True, h) for h, d in zip(cfg.num_heads, cfg.depths) for _ in range(d)])
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_mit_apply_under_autograd_asks_for_the_plain_chain(mit_b0, monkeypatch):
    """The route sees ``needs_grad`` where an input of the core requires a gradient (the
    graph rule, which asks ``takes`` too, is held apart by ``test_graphs_take``)."""
    model, images = mit_b0
    seen = []
    monkeypatch.setattr(tsa, "takes", lambda device, dtype, needs_grad, hd: seen.append(needs_grad))
    monkeypatch.setattr(tmit, "graphs_take", lambda *args: False)
    tmit.mit_apply(model, images)
    with torch.no_grad():
        tmit.mit_apply(model, images)
    blocks = sum(tmit.MIT_VARIANTS["mit_b0"].depths)
    assert seen == [True] * blocks + [False] * blocks


def test_scales_are_the_plain_chains():
    """The wrapper hands the kernel hd**-0.5 as ``scaled`` rounds it, and the kernel's
    exact path (``kExactScale``: the scale folded into q) holds at hd 64 alone, where the
    rounded scale is a power of two."""
    for hd in tsa.HEAD_DIMS:
        one = torch.ones(1, dtype=torch.bfloat16)
        assert scaled(one, hd**-0.5).item() == tsa.SCALES[hd]
    assert tsa.SCALES[64] == 0.125 and np.frexp(tsa.SCALES[32])[0] != 0.5
