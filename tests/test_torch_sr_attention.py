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

from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.kernels import sr_attention as tsa
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
], ids=["dtype", "kv_width", "batch", "dims", "head_dim", "empty", "contiguity", "alignment", "cpu"])
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


@pytest.fixture(scope="module")
def mit_b0():
    torch.manual_seed(0)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 64, 96, 3)).astype(np.float32))
    return tmit.MiT(tmit.MIT_VARIANTS["mit_b0"]), images


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mit_apply_on_the_cpu_never_reaches_the_kernel(mit_b0, dtype, monkeypatch):
    model, images = mit_b0
    monkeypatch.setattr(tsa, "sr_attention", lambda *args: pytest.fail("Kernel G was called on the CPU"))
    with torch.no_grad():
        outs = tmit.mit_apply(model, images, dtype)
    assert all(x.dtype == dtype for x in outs.values())


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_mit_apply_launches_once_per_block_where_the_rule_says_so(mit_b0, plain, monkeypatch):
    """Where ``takes`` says so, each block's core goes to the wrapper once, with the
    linears' outputs as they are (contiguous) and the block's heads; ``plain_versions()``
    keeps every core on the plain chain.  The rule answers as on the card, and the
    wrapper is stood in for by the plain chain."""
    model, images = mit_b0
    calls = []

    def fake(q, kv, heads):
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
    """The route sees ``needs_grad`` where an input of the core requires a gradient."""
    model, images = mit_b0
    seen = []
    monkeypatch.setattr(tsa, "takes", lambda device, dtype, needs_grad, hd: seen.append(needs_grad))
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
