"""Kernel H's route and its wrapper's argument checks, and the ViT / MViT plain attention
core, on the CPU.

``kernels/rel_pos_attention.py`` ``takes`` decides from what a call can observe whether an
attention core (``models/vit.py`` ``attention_core``, which MViT shares) runs Kernel H or
the plain chain ``rel_pos_attention_plain``; the wrapper checks its arguments before it
looks at the device, so CPU tensors reach every check without a launch.  The kernel
itself is held against the plain chain on the card (tests/test_torch_kernels_cuda.py).
"""
import contextlib

import numpy as np
import pytest
import torch

from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.kernels import rel_pos_attention as trp
from rba_tpu_torch.models import cuda_graphs
from rba_tpu_torch.models import mvit as tmvit
from rba_tpu_torch.models import vit as tvit

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device,dtype,needs_grad,head_dim,tables,want", [
    (CUDA, torch.bfloat16, False, 96, True, True),  # MViTv2-B serving
    (CUDA, torch.bfloat16, False, 64, True, True),  # ViTDet-B serving
    (CPU, torch.bfloat16, False, 96, True, False),
    (CUDA, torch.bfloat16, True, 96, True, False),  # training: the gradient is the plain chain's
    (CUDA, torch.float32, False, 96, True, False),
    (CUDA, torch.float16, False, 96, True, False),
    (CUDA, torch.bfloat16, False, 80, True, False),
    (CUDA, torch.bfloat16, False, 96, False, False),  # a core without position tables
], ids=["cuda_hd96", "cuda_hd64", "cpu", "grad", "fp32", "fp16", "hd80", "no_tables"])
def test_takes_kernel(device, dtype, needs_grad, head_dim, tables, want):
    assert trp.takes(device, dtype, needs_grad, head_dim, tables) is want
    with plain_versions():
        assert trp.takes(device, dtype, needs_grad, head_dim, tables) is False


@pytest.mark.parametrize("calls,kv_hw,want", [
    (8, (32, 64), True),  # MViTv2-B's global blocks at 1024x2048
    (12, (64, 128), True),  # ViTDet-B's global blocks at 1024x2048
    (400, (7, 7), True),
    (trp.MAX_CALLS, (14, 14), True),
    (trp.MAX_CALLS + 1, (14, 14), False),
    (12, (128, 256), False),  # ViTDet-B at 2048x4096: the position terms exceed shared memory
    (0, (14, 14), False),
], ids=["mvit_global", "vitdet_global", "mvit_windows", "most_calls", "too_many_calls", "table", "no_call"])
def test_takes_only_sizes_the_kernel_fits(calls, kv_hw, want):
    assert trp.fits(calls, kv_hw) is want
    assert trp.takes(CUDA, torch.bfloat16, False, 96, True, calls, kv_hw) is want


def _raw(calls=3, q_hw=(4, 5), kv_hw=(2, 3), hd=64, dtype=torch.bfloat16, table=None, seed=0):
    """q, k, v (calls, tokens, hd) in ``dtype`` and the two raw fp32 position tables (of
    ``table`` entries each, else the size the call meets, which needs no resampling)."""
    rs = np.random.default_rng(seed)
    nq, nk = q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1]
    q, k, v = (torch.tensor(rs.standard_normal((calls, n, hd)), dtype=torch.float32).to(dtype) for n in (nq, nk, nk))
    sizes = [table or 2 * max(q_hw[i], kv_hw[i]) - 1 for i in (0, 1)]
    rel_h, rel_w = (torch.tensor(0.3 * rs.standard_normal((n, hd)), dtype=torch.float32) for n in sizes)
    return q, k, v, rel_h, rel_w


def _reference_tables(rel_pos_h, rel_pos_w, rows, weights):
    """What the tables kernel computes from its arguments: each entry's two taps times
    their weights, each product rounded, their sum rounded to bf16.  Stands in for it on
    the CPU."""
    taps = torch.cat([rel_pos_h, rel_pos_w])[rows] * weights[:, None]
    n = taps.shape[0] // 2
    return (taps[:n] + taps[n:]).to(torch.bfloat16)


@pytest.fixture
def cpu_tables(monkeypatch):
    """The tables kernel stood in for by its reference; returns the calls made."""
    calls = []

    def fake(*args):
        calls.append(args)
        return _reference_tables(*args)

    monkeypatch.setattr(trp, "rel_pos_tables", fake)
    return calls


def _kernel_args(q, k, v, rel_h, rel_w, q_hw, kv_hw):
    """What ``attention_core`` hands the kernel (the tables by their reference)."""
    rows, weights, index = tvit._rel_pos_tables_constants((rel_h.shape[0], rel_w.shape[0]), q_hw, kv_hw, rel_h.device)
    both = _reference_tables(rel_h, rel_w, rows, weights)
    n_h = q_hw[0] * kv_hw[0]
    return (q, k, v, both[:n_h].view(q_hw[0], kv_hw[0], -1), both[n_h:], index, q_hw, kv_hw)


def _good():
    q_hw, kv_hw = (4, 5), (2, 3)
    return list(_kernel_args(*_raw(q_hw=q_hw, kv_hw=kv_hw), q_hw, kv_hw))


def _with(i, x):
    args = _good()
    args[i] = x(args[i]) if callable(x) else x
    return args


def _misaligned(x):
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)  # 2 bytes past the allocation
    return shifted.copy_(x)


@pytest.mark.parametrize("make,error,match", [
    (lambda: _with(0, lambda q: q.float()), TypeError, "bfloat16"),
    (lambda: _with(4, lambda rw: rw.float()), TypeError, "bfloat16"),
    (lambda: _with(5, lambda ix: ix.long()), TypeError, "int32"),
    (lambda: _with(1, lambda k: k[:, :-1]), ValueError, "do not match"),
    (lambda: _with(2, lambda v: v[:2]), ValueError, "do not match"),
    (lambda: _with(3, lambda rh: rh[:, :1]), ValueError, "do not match"),
    (lambda: _with(5, lambda ix: ix[:, :1].contiguous()), ValueError, "do not match"),
    (lambda: _with(6, (5, 5)), ValueError, "do not match"),
    (lambda: _with(0, lambda q: q[0]), ValueError, r"\(calls, tokens, hd\)"),
    (lambda: _with(4, lambda rw: rw[None]), ValueError, r"\(entries, hd\)"),
    (lambda: [t[..., :48] for t in _good()[:3]] + [t[..., :48] for t in _good()[3:5]] + _good()[5:],
     ValueError, "head dims"),
    (lambda: _with(0, lambda q: torch.cat([q, q[..., :4]], dim=-1)[..., :q.shape[-1]]), ValueError,
     "cuda device"),  # rows 136 bytes apart: q is read by its strides, so only the device is left to refuse
    (lambda: _with(1, _misaligned), ValueError, "16-byte words"),
    (lambda: _with(3, lambda rh: rh.transpose(0, 1).contiguous().transpose(0, 1)), ValueError, "16-byte words"),
    (lambda: _good(), ValueError, "cuda device"),
    (lambda: _with(2, lambda v: torch.cat([v, v[..., :4]], dim=-1)[..., :v.shape[-1]]), ValueError,
     "16-byte words"),  # rows 136 bytes apart
    (lambda: _with(0, lambda q: q.transpose(1, 2).contiguous().transpose(1, 2)), ValueError, "cuda device"),
    (lambda: _with(1, lambda k: k.transpose(1, 2).contiguous().transpose(1, 2)), ValueError, "16-byte words"),
], ids=["q_dtype", "rw_dtype", "index_dtype", "k_tokens", "v_calls", "rh_shape", "index_shape", "kv_hw", "q_dims",
        "rw_dims", "head_dim", "q_strides", "k_alignment", "rh_contiguity", "cpu", "v_strides", "q_channel_major",
        "k_channel_major"])
def test_wrapper_checks_raise_without_a_launch(make, error, match):
    before = trp.rel_pos_attention.launches
    with pytest.raises(error, match=match):
        trp.rel_pos_attention(*make())
    assert trp.rel_pos_attention.launches == before


def _table_args():
    """The tables kernel's arguments for a 3 x 5 call on 13-entry tables (resampled)."""
    rel_h, rel_w = (0.3 * torch.randn(13, 64) for _ in range(2))
    rows, weights, _ = tvit._rel_pos_tables_constants((13, 13), (3, 5), (3, 5), rel_h.device)
    return [rel_h, rel_w, rows, weights]


def _table_with(i, x):
    args = _table_args()
    args[i] = x(args[i])
    return args


@pytest.mark.parametrize("make,error,match", [
    (lambda: _table_with(0, lambda t: t.bfloat16()), TypeError, "float32 rel_pos_h"),
    (lambda: _table_with(1, lambda t: t.t().contiguous().t()), TypeError, "contiguous"),
    (lambda: _table_with(2, lambda r: r.int()), TypeError, "int64 rows"),
    (lambda: _table_with(3, lambda w: w[:-1]), ValueError, r"\(2 n,\)"),
    (lambda: _table_with(2, lambda r: r[None]), ValueError, r"\(2 n,\)"),
    (lambda: _table_with(1, lambda t: t[:, :32].contiguous()), ValueError, "one hd"),
    (lambda: _table_args(), ValueError, "cuda device"),
], ids=["h_dtype", "w_contiguity", "rows_dtype", "weights_shape", "rows_dims", "hd", "cpu"])
def test_tables_wrapper_checks_raise_without_a_launch(make, error, match):
    before = trp.rel_pos_tables.launches
    with pytest.raises(error, match=match):
        trp.rel_pos_tables(*make())
    assert trp.rel_pos_tables.launches == before


def test_wrapper_refuses_too_large_a_table():
    q_hw, kv_hw = (2, 2), (100, 201)  # kw + 2 kh > MAX_TABLE
    args = _kernel_args(*_raw(calls=1, q_hw=q_hw, kv_hw=kv_hw), q_hw, kv_hw)
    with pytest.raises(ValueError, match="kw \\+ 2 kh"):
        trp.rel_pos_attention(*args)


def _inline_core(q, k, v, q_hw, kv_hw, rel_pos_h=None, rel_pos_w=None):
    """The core as ``attention_core`` computed it inline before ``rel_pos_attention_plain``."""
    dt = q.dtype
    attn = torch.matmul(tvit.scaled(q, q.shape[-1] ** -0.5), k.transpose(-1, -2))
    if rel_pos_h is not None:
        rh = tvit.rel_pos_resampled(rel_pos_h, q_hw[0], kv_hw[0]).to(dt)
        rw = tvit.rel_pos_resampled(rel_pos_w, q_hw[1], kv_hw[1]).to(dt)
        r_q = q.reshape(-1, q_hw[0], q_hw[1], q.shape[-1])
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = attn.reshape(-1, q_hw[0], q_hw[1], kv_hw[0], kv_hw[1])
        attn = (attn + rel_h[:, :, :, :, None]) + rel_w[:, :, :, None, :]
        attn = attn.reshape(-1, q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1])
    p = torch.softmax(attn.float(), dim=-1).to(dt)
    return torch.matmul(p, v)


# (q_hw, kv_hw, raw table entries or None): MViTv2-B's window kinds, scaled down (q and
# kv strided alike, by 2 or 4), equal sizes, one that resamples the tables, one key
CORE_SHAPES = [((8, 8), (2, 2), None), ((4, 4), (4, 4), None), ((4, 4), (8, 8), None), ((3, 5), (3, 5), 13),
               ((1, 1), (1, 1), None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CORE_SHAPES, ids=["q_over_4", "equal", "kv_over_2", "resampled", "one_key"])
def test_plain_equals_the_inline_core(shape, dtype):
    """``rel_pos_attention_plain`` equals the core ``attention_core`` computed inline, bit
    for bit, with and without position tables."""
    q_hw, kv_hw, table = shape
    q, k, v, rel_h, rel_w = _raw(calls=4, q_hw=q_hw, kv_hw=kv_hw, dtype=dtype, table=table)
    for tables in ((rel_h, rel_w), ()):
        got = tvit.rel_pos_attention_plain(q, k, v, q_hw, kv_hw, *tables)
        assert torch.equal(got, _inline_core(q, k, v, q_hw, kv_hw, *tables))
        assert torch.equal(tvit.attention_core(q, k, v, q_hw, kv_hw, *tables), got)  # the CPU takes the chain


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q,k", [(56, 14), (28, 28), (14, 28), (7, 7), (256, 64), (5, 3), (3, 5), (1, 1)])
def test_rel_pos_tables_are_the_chains(q, k, dtype, cpu_tables):
    """``rel_pos_tables`` makes the chain's tables, cast to bf16, bit for bit, from
    parameters in ``dtype``, whether the call resamples them or not, in one call of the
    tables kernel (stood in for by its reference): R_h as ``rel_pos_resampled`` gathers
    it, and R_w resampled, whose int32 index gathers it into the chain's.  The index grows
    with the query position and falls with the key's, which the kernel's range of entries
    relies on."""
    q_hw, kv_hw = (q, k), (k, q)
    for extra in (4, 0):
        rel_h, rel_w = (torch.randn(2 * max(q, k) - 1 + extra, 8).to(dtype) for _ in range(2))
        before = len(cpu_tables)
        rh, rw, index = tvit.rel_pos_tables(rel_h, rel_w, q_hw, kv_hw)
        assert len(cpu_tables) == before + 1 and all(t.dtype == torch.float32 for t in cpu_tables[-1][:2])
        assert rh.dtype == rw.dtype == torch.bfloat16 and rw.shape == (2 * max(q, k) - 1, 8)
        assert index.dtype == torch.int32 and index.shape == (k, q)
        assert torch.equal(rh, tvit.rel_pos_resampled(rel_h, q, k).to(torch.bfloat16))
        assert torch.equal(rw[index.long()], tvit.rel_pos_resampled(rel_w, k, q).to(torch.bfloat16))
        assert bool((index.diff(dim=0) >= 0).all()) and bool((index.diff(dim=1) <= 0).all())
        assert int(index.min()) >= 0 and int(index.max()) < rw.shape[0]


def _reference_kernel(q, k, v, rh, rw, rw_index, q_hw, kv_hw):
    """What the kernel computes from its arguments, as the chain rounds it: stands in for
    it on the CPU."""
    assert all(trp.readable(t) is t for t in (k, v))
    assert rh.dtype == rw.dtype == q.dtype and rw_index.dtype == torch.int32
    r_q = q.reshape(-1, q_hw[0], q_hw[1], q.shape[-1])
    attn = torch.matmul(tvit.scaled(q, q.shape[-1] ** -0.5), k.transpose(-1, -2))
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw[rw_index.long()])
    attn = attn.reshape(-1, q_hw[0], q_hw[1], kv_hw[0], kv_hw[1])
    attn = (attn + rel_h[:, :, :, :, None]) + rel_w[:, :, :, None, :]
    p = torch.softmax(attn.reshape(q.shape[0], q.shape[1], -1).float(), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


@pytest.fixture
def on_card(monkeypatch, cpu_tables):
    """The rule answers as on the card and both wrappers are stood in for by their
    references; returns the calls the route made to the attention kernel."""
    calls = []
    real = trp.takes

    def fake(*args):
        calls.append(args)
        return _reference_kernel(*args)

    monkeypatch.setattr(trp, "takes", lambda device, *args: real(CUDA, *args))
    monkeypatch.setattr(trp, "rel_pos_attention", fake)
    return calls


@pytest.mark.parametrize("shape", CORE_SHAPES, ids=["q_over_4", "equal", "kv_over_2", "resampled", "one_key"])
def test_route_hands_the_kernel_what_the_chain_reads(shape, on_card, cpu_tables):
    """Where the rule says so the core goes to the wrapper once, with q as it is, readable
    k and v (a view whose rows the kernel cannot read is copied), R_h gathered and R_w
    with its index, in the compute dtype, the tables from one call of the tables kernel:
    the chain computed from those equals ``rel_pos_attention_plain`` bit for bit."""
    q_hw, kv_hw, table = shape
    q, k, v, rel_h, rel_w = _raw(calls=4, q_hw=q_hw, kv_hw=kv_hw, table=table)
    want = tvit.rel_pos_attention_plain(q, k, v, q_hw, kv_hw, rel_h, rel_w)
    wide = torch.cat([k, k], dim=-1)[..., :k.shape[-1]]  # rows 256 bytes apart, readable as they are
    odd_q, odd_v = (torch.cat([t, t[:, :, :4]], dim=-1)[..., :t.shape[-1]] for t in (q, v))  # rows 136 bytes apart
    with torch.no_grad():
        got = tvit.attention_core(odd_q, wide, odd_v, q_hw, kv_hw, rel_h, rel_w)
    assert len(on_card) == 1 and on_card[0][0] is odd_q and on_card[0][1] is wide and on_card[0][2] is not odd_v
    assert len(cpu_tables) == 1
    assert torch.equal(got, want)
    with torch.no_grad():
        tvit.attention_core(q, k, v, q_hw, kv_hw)  # no tables: the chain
    assert len(on_card) == 1


def test_readable_copies_only_what_the_kernel_cannot_read():
    x = torch.zeros(3, 10, 64, dtype=torch.bfloat16)
    assert trp.readable(x) is x
    w = torch.zeros(3, 10, 128, dtype=torch.bfloat16)[..., :64]  # rows 256 bytes apart: read by strides
    assert trp.readable(w) is w
    y = torch.zeros(3, 10, 68, dtype=torch.bfloat16)[..., :64]  # rows 136 bytes apart
    assert trp.readable(y) is not y and trp.readable(y).is_contiguous() and torch.equal(trp.readable(y), y)
    z = torch.zeros(1, 1, 65, dtype=torch.bfloat16)[..., 1:]  # starts 2 bytes in
    assert trp.readable(z).data_ptr() % 16 == 0


def _small_mvit(seed: int = 0):
    torch.manual_seed(seed)
    model = tmvit.MViT(tmvit.MViTConfig()).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(std=0.02)
    images = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, 64, 96, 3)).astype(np.float32))
    return model, images


def _small_vit(seed: int = 0):
    torch.manual_seed(seed)
    model = tvit.ViT(tvit.ViTConfig(depth=4, window_block_indexes=(0, 2))).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(std=0.02)
    images = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, 64, 96, 3)).astype(np.float32))
    return model, images


@pytest.fixture(scope="module")
def mvit_b():
    return _small_mvit()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mvit_and_vit_apply_on_the_cpu_never_reach_the_kernel(mvit_b, dtype, monkeypatch):
    """On the CPU every core takes the plain chain: the forwards equal those under
    ``plain_versions()``, never call Kernel H and capture nothing."""
    monkeypatch.setattr(trp, "rel_pos_attention", lambda *args, **kw: pytest.fail("Kernel H was called on the CPU"))
    monkeypatch.setattr(trp, "rel_pos_tables", lambda *args, **kw: pytest.fail("the tables kernel was called on the CPU"))
    vit_model, vit_images = _small_vit()
    for apply, (model, images) in ((tmvit.mvit_apply, mvit_b), (tvit.vit_apply, (vit_model, vit_images))):
        with torch.no_grad():
            got = apply(model, images, dtype)
            with plain_versions():
                want = apply(model, images, dtype)
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
        assert all(x.dtype == dtype for x in got.values())
    assert mvit_b[0] not in cuda_graphs._CACHE


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_mvit_apply_launches_once_per_block_where_the_rule_says_so(mvit_b, plain, on_card):
    """Where ``takes`` says so, each block's core goes to the wrapper once (24 MViTv2-B
    blocks) and the forward equals the plain one bit for bit; ``plain_versions()`` keeps
    every core on the plain chain.  The rule answers as on the card, and the wrapper is
    stood in for by the reference."""
    model, images = mvit_b
    with torch.no_grad(), plain_versions():
        want = tmvit.mvit_apply(model, images)
    with torch.no_grad(), plain_versions() if plain else contextlib.nullcontext():
        got = tmvit.mvit_apply(model, images)
    assert len(on_card) == (0 if plain else len(model.blocks))
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_under_autograd_the_core_asks_for_the_plain_chain(mvit_b, monkeypatch):
    """The route sees ``needs_grad`` where an input of the core requires a gradient."""
    model, images = mvit_b
    seen = []
    real = trp.takes
    monkeypatch.setattr(trp, "takes", lambda device, dtype, needs_grad, *args: seen.append(needs_grad) or False)
    tmvit.mvit_apply(model, images)
    with torch.no_grad():
        tmvit.mvit_apply(model, images)
    blocks = len(model.blocks)
    assert seen == [True] * blocks + [False] * blocks
    assert real(CUDA, torch.bfloat16, True, 96) is False


def test_scales_are_the_plain_chains():
    """The wrapper hands the kernel hd**-0.5 as ``scaled`` rounds it."""
    for hd in trp.HEAD_DIMS:
        assert tvit.scaled(torch.ones(1, dtype=torch.bfloat16), hd**-0.5).item() == trp.SCALES[hd]
