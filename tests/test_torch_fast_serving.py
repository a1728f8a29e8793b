"""The port's bf16 rounding and its ``fast_serving`` slice against rba_tpu on the CPU.

rba_tpu is called op by op, as its own tests call it, so each op of its jaxpr rounds
to its dtype.  (Under ``jax.jit`` the CPU compiler may keep bf16 intermediates in
fp32, so a jitted rba_tpu rounds in fewer places; see ROADMAP.md §C.)

Measures, each stated where it is used:

- share of equal elements: the two packages round in the same places and sum in
  the same order, so their bf16 results are the same numbers;
- share within one bf16 ulp of each element's own value (``ulp_share``, the bound of
  tests/test_torch_window_attention.py): where fp32 sums run in another order, or
  ``exp`` differs in its last bit, a bf16 result may round the other way;
- for fp32 outputs of bf16 inputs, a relative bound of fp32 rounding (1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu.models import pixel_decoder as jpd
from rba_tpu.models import swin as jswin
from rba_tpu.ops import deform_sampling as jds
from rba_tpu.ops import nn as jnn
from rba_tpu.ops import resize as jrs
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import load_jax_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import pixel_decoder as tpd
from rba_tpu_torch.models import swin as tswin
from rba_tpu_torch.ops import deform_sampling as tds
from rba_tpu_torch.ops import nn as tnn
from rba_tpu_torch.ops import resize as trs
from tests.torch_port_common import (equal_share, max_abs, model_pair, perturbed, record, t, to_jax, to_np,
                                     ulp_share)

BLOCK_SHARE = 0.9999  # least ulp_share of one Swin block
# Least ulp_share of one op that sums in fp32 (a product, LayerNorm, the attention
# core), given rba_tpu's input: the acceptance figure of swin_apply.  Measured when
# written: 0.99984 at the least (the attention core).
OP_SHARE = 0.999
# Floor of the ulp_share of a whole swin_apply output as the port computes it.  This
# is a known miss, recorded open in ROADMAP.md §C.1, and not the accepted bound: the
# aim is 0.999 at every output.  Measured when written: res3 0.99878 at (1, 64, 64)
# and 0.99710 at (2, 36, 52); res2 1.0 and 0.9996.  Where the two packages part is
# measured op by op (test_bf16_block_op_by_op_against_rba_tpu): only LayerNorm's
# moments and the attention core's fp32 arithmetic (exp in its last bit, the order
# of the fp32 sums) differ.  With rba_tpu's LayerNorm and attention core swapped in,
# the port's swin_apply equals rba_tpu's bit for bit at every output
# (test_swin_apply_bf16_equal_with_rba_tpus_norm_and_attention_core), so the
# acceptance bound holds for every rounding the port chooses.
SWIN_SHARE = 0.995
SAMPLING_RTOL = 1e-5  # relative to the largest output: fp32 sums in another order
PD_FAST_RTOL = 1e-4  # fp32 outputs of the bf16 pixel decoder, relative to the largest
# Score maps at fast_serving: ten times the fp32 selfcheck bound (1e-3), as the bf16
# backbone's remaining flips (SWIN_SHARE) reach the scores.  Measured when written:
# 4.5e-3 on the tiny config.
FAST_SCORE_TOL = 1e-2


def bf16(a: np.ndarray):
    """The same bf16 values as (jax array, torch tensor)."""
    tb = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16), tb


# ---------------------------------------------------------------------------
# Part 1: the bf16 roundings of the Swin backbone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["linear", "conv1x1", "conv3x3"])
def test_bf16_linear_and_conv_equal_rba_tpu(rng, request, op):
    """x·W rounded to bf16, then the bf16 bias added and rounded again
    (rba_tpu/ops/nn.py:24-27, :92-94, :104-105).  Share of equal elements: 1.0."""
    c_in, c_out = 32, 96
    jx, tx = bf16(rng.randn(2, 8, 12, c_in))
    b = rng.randn(c_out).astype(np.float32)
    if op == "linear":
        k = (rng.randn(c_in, c_out) * 0.2).astype(np.float32)
        want = jnn.linear({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}, jx)
        got = tnn.linear(tx, t(k.T), t(b))
    else:
        ks = 1 if op == "conv1x1" else 3
        w = (rng.randn(ks, ks, c_in, c_out) * 0.1).astype(np.float32)  # HWIO
        want = jnn.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jx)
        got = tnn.conv2d(tx, t(w.transpose(3, 2, 0, 1)), t(b))
    assert got.dtype == torch.bfloat16
    record(request, equal_share=equal_share(got, want))
    assert equal_share(got, want) == 1.0


def test_bf16_patch_embed_equal_rba_tpu(rng):
    """The patch embed of swin_apply, held against rba_tpu's steps (space-to-depth,
    a bf16 product, then the bf16 bias; rba_tpu/models/swin.py:670-681) by comparing
    the first blocks' input: a Swin with no blocks returns LayerNorm(patch embed)."""
    cfg_kw = dict(embed_dim=32, depths=(0,), num_heads=(2,), window_size=4, out_features=("res2",))
    jcfg = dataclasses.replace(jconfig.SwinConfig(), **cfg_kw)
    params = perturbed(jswin.swin_init(jax.random.PRNGKey(5), jcfg), seed=6)
    tcfg = dataclasses.replace(tconfig.SwinConfig(), **cfg_kw)
    model = tswin.Swin(tcfg)
    load_jax_params(model, params)
    images = rng.randn(2, 36, 44, 3).astype(np.float32)
    want = jswin.swin_apply(to_jax(params), jcfg, jnp.asarray(images), compute_dtype=jnp.bfloat16)["res2"]
    with torch.no_grad():
        got = tswin.swin_apply(model, tcfg, t(images), compute_dtype=torch.bfloat16)["res2"]
    assert equal_share(got, want) == 1.0


def test_bf16_gelu_equal_rba_tpu(rng, request):
    """jax.nn.gelu(approximate=False) on bf16: its jaxpr's five ops, each rounded to
    bf16.  Share of equal elements: 1.0 (F.gelu, which rounds once, falls short: the
    test records its share)."""
    jx, tx = bf16(rng.randn(4, 64, 128) * 2)
    want = jax.nn.gelu(jx, approximate=False)
    got = tswin.gelu(tx)
    assert got.dtype == torch.bfloat16
    record(request, equal_share=equal_share(got, want), f_gelu_equal_share=equal_share(torch.nn.functional.gelu(tx),
                                                                                        want))
    assert equal_share(got, want) == 1.0


@pytest.fixture(scope="module")
def tiny_swin():
    params = perturbed(jswin.swin_init(jax.random.PRNGKey(0), jconfig.tiny_test_config().swin), seed=1)
    model = tswin.Swin(tconfig.tiny_test_config().swin)
    load_jax_params(model, params)
    return params, model


@pytest.mark.parametrize("fast_math", [False, True], ids=["factorized", "fast_math"])
@pytest.mark.parametrize("blk, shift", [(0, 0), (1, 2)], ids=["block0", "shifted_block1"])
def test_xla_block_bf16_matches_rba_tpu(tiny_swin, rng, request, blk, shift, fast_math):
    """One block through the ``"xla"`` branch (rba_tpu's default chain) on a padded
    (1, 9, 13) bf16 map: ulp_share >= 0.9999."""
    params, model = tiny_swin
    jx, tx = bf16(rng.randn(1, 9, 13, 32))
    want = jswin.swin_block_apply(to_jax(params["layers"][0]["blocks"][blk]), jx, num_heads=2, ws=4, shift=shift,
                                  qk_scale=None, fast_math=fast_math)
    with torch.no_grad():
        got = tswin.swin_block_apply(model.layers[0].blocks[blk], tx, 2, 4, shift, None, attention="xla",
                                     fast_math=fast_math)
    assert got.dtype == torch.bfloat16
    record(request, equal_share=equal_share(got, want), ulp_share=ulp_share(got, want))
    assert ulp_share(got, want) >= BLOCK_SHARE


def test_fused_softmax_under_fast_math_is_the_xla_chain(tiny_swin, rng):
    """rba_tpu ignores its fused-softmax switch under fast_math; so does the port."""
    _, model = tiny_swin
    _, tx = bf16(rng.randn(1, 9, 13, 32))
    blk = model.layers[0].blocks[1]
    with torch.no_grad():
        a = tswin.swin_block_apply(blk, tx, 2, 4, 2, None, attention="fused_softmax", fast_math=True)
        b = tswin.swin_block_apply(blk, tx, 2, 4, 2, None, attention="xla", fast_math=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bhw", [(2, 36, 52), (1, 64, 64)], ids=["pad_b2", "even_b1"])
def test_swin_apply_bf16_xla_matches_rba_tpu(tiny_swin, rng, request, bhw):
    """Whole swin_apply at bf16 through the ``"xla"`` branch: ulp_share >= SWIN_SHARE at
    every output (see SWIN_SHARE for what is left)."""
    params, model = tiny_swin
    images = rng.randn(*bhw, 3).astype(np.float32)
    want = jswin.swin_apply(to_jax(params), jconfig.tiny_test_config().swin, jnp.asarray(images),
                            compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = tswin.swin_apply(model, tconfig.tiny_test_config().swin, t(images), compute_dtype=torch.bfloat16,
                               attention="xla")
    assert sorted(got) == sorted(want) == ["res2", "res3"]
    record(request, **{f"equal_share_{k}": equal_share(got[k], want[k]) for k in got},
           **{f"ulp_share_{k}": ulp_share(got[k], want[k]) for k in got})
    for k in got:
        assert ulp_share(got[k], want[k]) >= SWIN_SHARE, k


def _rba_tpu_layer_norm(norm, x: torch.Tensor) -> torch.Tensor:
    """rba_tpu's layer_norm (single-pass fp32 moments, in XLA's summation order) on the
    port's module and activation."""
    p = {"scale": jnp.asarray(to_np(norm.weight)), "bias": jnp.asarray(to_np(norm.bias))}
    return torch.from_numpy(to_np(jnn.layer_norm(p, bf16(to_np(x))[0]))).to(x.dtype)


def _rba_tpu_attention_core(qkv, rel_bias, mask, nh, scale, fast_math=False):
    """rba_tpu's default attention chain (``_window_attention`` up to the projection,
    rba_tpu/models/swin.py:236-327) on the port's qkv, with the arguments of the port's
    ``xla_attention``.  The bias table is recovered from ``rel_bias``: every relative
    position occurs in it."""
    n = rel_bias.shape[-1]
    ws = int(round(n**0.5))
    table = np.zeros(((2 * ws - 1) ** 2, nh), np.float32)
    table[jswin.relative_position_index(ws).reshape(-1)] = to_np(rel_bias).transpose(1, 2, 0).reshape(n * n, nh)
    nw = 1 if mask is None else mask.shape[0]
    qkv_pre = bf16(to_np(qkv).reshape(-1, nw, 1, n, qkv.shape[-1]))[0]
    out = jswin._window_attention({"relative_position_bias_table": jnp.asarray(table)}, None, nh, ws,
                                  None if mask is None else to_np(mask), scale, fast_math=fast_math,
                                  apply_proj=False, qkv_pre=qkv_pre)
    return torch.from_numpy(to_np(out)).to(qkv.dtype).reshape(qkv.shape[0], n, -1)


def test_bf16_block_op_by_op_against_rba_tpu(tiny_swin, rng, request):
    """Where the bf16 backbones part, op by op: stage 0's block 0 on a padded (2, 9, 13)
    map, each op of the port given rba_tpu's input to that op.  The elementwise ops
    (GELU, the residual add) are equal (share 1.0).  The others sum in fp32 and round
    once to bf16, as rba_tpu does, but their fp32 arithmetic differs: XLA sums a row or
    a dot product in another order, and its exp differs from torch's in the last bit.
    So a bf16 result near a rounding edge may round the other way: their shares are
    recorded, and held at OP_SHARE within one ulp.  The test records also the shares
    of equal fp32 values of exp and of the row sums."""
    params, model = tiny_swin
    bp, blk = to_jax(params["layers"][0]["blocks"][0]), model.layers[0].blocks[0]
    x, tx = bf16(rng.randn(2, 9, 13, 32))
    shares = {}

    def step(name, got, want, elementwise=False):
        shares[name], shares[f"{name}_within_one_ulp"] = equal_share(got, want), ulp_share(got, want)
        assert (shares[name] == 1.0) if elementwise else (ulp_share(got, want) >= OP_SHARE), name
        return want

    ln1 = step("norm1", tnn.apply_norm(blk.norm1, tx), jnn.layer_norm(bp["norm1"], x))
    xw = jnp.pad(ln1, ((0, 0), (0, 3), (0, 3), (0, 0))).reshape(2, 3, 4, 4, 4, 32)
    xw = jnp.transpose(xw, (0, 1, 3, 2, 4, 5)).reshape(2, 3, 4, 16, 32)
    txw = torch.from_numpy(to_np(xw)).to(torch.bfloat16)
    qkv = step("qkv", tnn.apply_linear(blk.attn.qkv, txw), jnn.linear(bp["attn"]["qkv"], xw))
    tqkv = torch.from_numpy(to_np(qkv)).to(torch.bfloat16).reshape(-1, 16, 96)
    rel_bias = tswin._rel_bias(blk.attn, 4, 2)
    q, k, _ = tswin._split_heads(tqkv, 2, 0.25)
    q5 = qkv.reshape(-1, 16, 3, 2, 16)  # rba_tpu/models/swin.py:236-265
    s = step("scores", torch.matmul(q, k.transpose(-1, -2)),
             jnp.einsum("wqhd,wkhd->whqk", q5[..., 0, :, :] * 0.25, q5[..., 1, :, :],
                        preferred_element_type=jnp.bfloat16))
    s32 = to_np(s)
    e = np.asarray(jnp.exp(jnp.asarray(s32 - s32.max(-1, keepdims=True))))
    # torch.tensor copies into torch's own aligned buffer: which elements take the
    # vectorised path of torch's CPU exp depends on the buffer's alignment
    shares["exp_fp32"] = float((torch.exp(torch.tensor(s32 - s32.max(-1, keepdims=True))).numpy() == e).mean())
    shares["row_sum_fp32"] = float((torch.tensor(e).sum(-1).numpy() == np.asarray(jnp.sum(jnp.asarray(e), -1))).mean())
    core = _rba_tpu_attention_core(tqkv, rel_bias, None, 2, 0.25)
    step("attention_core", tswin.xla_attention(tqkv, rel_bias, None, 2, 0.25), core)
    pre = jnp.asarray(to_np(core)).astype(jnp.bfloat16)
    proj = step("proj", tnn.apply_linear(blk.attn.proj, core), jnn.linear(bp["attn"]["proj"], pre))
    xr = jnp.transpose(proj.reshape(2, 3, 4, 4, 4, 32), (0, 1, 3, 2, 4, 5)).reshape(2, 12, 16, 32)[:, :9, :13]
    tr1 = tx + torch.from_numpy(to_np(xr)).to(torch.bfloat16)
    r1 = step("residual1", tr1, x + xr, elementwise=True)
    ln2 = step("norm2", tnn.apply_norm(blk.norm2, tr1), jnn.layer_norm(bp["norm2"], r1))
    tln2 = torch.from_numpy(to_np(ln2)).to(torch.bfloat16)
    f1 = step("fc1", tnn.apply_linear(blk.mlp["fc1"], tln2), jnn.linear(bp["mlp"]["fc1"], ln2))
    tf1 = torch.from_numpy(to_np(f1)).to(torch.bfloat16)
    g = step("gelu", tswin.gelu(tf1), jax.nn.gelu(f1, approximate=False), elementwise=True)
    step("fc2", tnn.apply_linear(blk.mlp["fc2"], torch.from_numpy(to_np(g)).to(torch.bfloat16)),
         jnn.linear(bp["mlp"]["fc2"], g))
    record(request, **{f"equal_share_{k}": v for k, v in shares.items()})


@pytest.mark.parametrize("bhw", [(2, 36, 52), (1, 64, 64)], ids=["pad_b2", "even_b1"])
def test_swin_apply_bf16_equal_with_rba_tpus_norm_and_attention_core(tiny_swin, rng, request, monkeypatch, bhw):
    """The acceptance bound of swin_apply at bf16 (share within one ulp >= 0.999 at every
    output) for every rounding the port chooses: with rba_tpu's layer_norm and its
    attention core swapped in for the port's, the port's ``"xla"`` branch equals rba_tpu
    bit for bit (share of equal elements 1.0) at every output.  What is left of the
    SWIN_SHARE miss therefore lies in those two ops' fp32 arithmetic alone."""
    params, model = tiny_swin
    monkeypatch.setattr(tswin, "apply_norm", _rba_tpu_layer_norm)
    monkeypatch.setattr(tswin, "xla_attention", _rba_tpu_attention_core)
    images = rng.randn(*bhw, 3).astype(np.float32)
    want = jswin.swin_apply(to_jax(params), jconfig.tiny_test_config().swin, jnp.asarray(images),
                            compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = tswin.swin_apply(model, tconfig.tiny_test_config().swin, t(images), compute_dtype=torch.bfloat16,
                               attention="xla")
    record(request, **{f"equal_share_{k}": equal_share(got[k], want[k]) for k in got})
    for k in want:
        assert equal_share(got[k], want[k]) == 1.0, k


# ---------------------------------------------------------------------------
# Part 2: the fast_serving slice
# ---------------------------------------------------------------------------

def test_fast_serving_config_matches_rba_tpu():
    for name in ("swin_b_1dl", "tiny_test_config"):
        j = jconfig.fast_serving(getattr(jconfig, name)())
        p = tconfig.fast_serving(getattr(tconfig, name)())
        for f in dataclasses.fields(p.pixel_decoder):
            assert getattr(p.pixel_decoder, f.name) == getattr(j.pixel_decoder, f.name), (name, f.name)
        assert (p.pixel_decoder_dtype, p.fast_math) == (j.pixel_decoder_dtype, j.fast_math) == ("bfloat16", True)
        tconfig.check_supported(p)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_upsample2x_bf16_equal_rba_tpu(rng, in_dtype):
    """The FPN's 2× upsample with compute_dtype=bf16: two passes, each rounded to bf16,
    cast back to the input's dtype.  Equal to upsample2x_bilinear_nhwc."""
    x = (rng.randn(2, 7, 9, 16) * 3).astype(np.float32)
    jx, tx = (jnp.asarray(x), t(x)) if in_dtype == "float32" else bf16(x)
    want = jrs.resize_bilinear_nhwc(jx, (14, 18), compute_dtype=jnp.bfloat16)
    got = trs.resize_bilinear_nhwc(tx, (14, 18), compute_dtype=torch.bfloat16)
    assert got.dtype == tx.dtype and str(want.dtype) == in_dtype
    assert equal_share(got, want) == 1.0


def _sampling_inputs(rng, shapes, collide: bool):
    n, m, d, lq, p = 2, 4, 8, 13, 3
    s = sum(h * w for h, w in shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (n, lq, m, len(shapes), p, 2)).astype(np.float32)
    if collide:  # point 1 lands a few hundredths of a pixel from point 0: they share their corners
        loc[..., 1, :] = loc[..., 0, :] + 0.002
    aw = rng.rand(n, lq, m, len(shapes), p).astype(np.float32)
    aw /= aw.sum(axis=(-2, -1), keepdims=True)
    return value, loc, aw


def _gather_rounding_each_weight(value, shapes, loc, aw):
    """The counter-example: a gather port that rounds each corner's weight to bf16 and
    sums the corners of a query in fp32.  Where two points of a query share a pixel,
    rba_tpu rounds the pixel's summed weight once, so the two differ."""
    v = torch.from_numpy(value).to(torch.bfloat16).float()
    n, _, m, d = value.shape
    out, start = 0.0, 0
    for lid, (h, w) in enumerate(shapes):
        lv = v[:, start:start + h * w].reshape(n, h, w, m, d)
        ll, la = torch.from_numpy(loc[:, :, :, lid]), torch.from_numpy(aw[:, :, :, lid])
        x, y = ll[..., 0] * w - 0.5, ll[..., 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        tx_, ty_ = x - x0, y - y0
        table = lv.permute(0, 3, 1, 2, 4).reshape(n * m, h * w, d)
        for (dy, dx), wt in zip(tds._CORNERS, ((1 - tx_) * (1 - ty_), tx_ * (1 - ty_), (1 - tx_) * ty_, tx_ * ty_)):
            xi, yi = x0.long() + dx, y0.long() + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            wgt = (torch.where(valid, wt, 0.0) * la).to(torch.bfloat16).float()  # each weight rounded
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).permute(0, 2, 1, 3).reshape(n * m, -1, 1)
            g = torch.gather(table, 1, idx.expand(-1, -1, d)).reshape(n, m, *wgt.shape[1:2], -1, d)
            out = out + (g * wgt.permute(0, 2, 1, 3)[..., None]).sum(dim=3).permute(0, 2, 1, 3)
        start += h * w
    return out.reshape(n, -1, m * d)


@pytest.mark.parametrize("sampling_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("collide", [False, True], ids=["spread", "colliding"])
def test_onehot_sampling_matches_rba_tpu(rng, request, sampling_dtype, collide):
    """ms_deform_attn_core(method="onehot") at both sampling dtypes within fp32 rounding
    (SAMPLING_RTOL of the largest output).  In the colliding case a gather that rounds
    each corner's weight misses that bound."""
    shapes = [(6, 9), (3, 5)]
    value, loc, aw = _sampling_inputs(rng, shapes, collide)
    want = to_np(jds.ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw),
                                       method="onehot", sampling_dtype=sampling_dtype))
    got = tds.ms_deform_attn_core(t(value), shapes, t(loc), t(aw), method="onehot", sampling_dtype=sampling_dtype)
    tol = SAMPLING_RTOL * np.abs(want).max()
    record(request, max_abs=max_abs(got, want), tol=tol)
    assert got.dtype == torch.float32
    assert max_abs(got, want) <= tol
    if collide and sampling_dtype == "bfloat16":
        counter = _gather_rounding_each_weight(value, shapes, loc, aw)
        record(request, max_abs_gather_rounding_each_weight=max_abs(counter, want))
        assert max_abs(counter, want) > 10 * tol


def test_auto_dispatch_picks_rba_tpus_method_per_level(rng, request):
    """With a cap between the two levels' N·M·Lq·H·W, "auto" takes the one-hot form on
    the small level and the gather on the large one, as rba_tpu does; each other
    choice moves the bf16 result by more than the bound."""
    shapes = [(6, 9), (3, 5)]
    value, loc, aw = _sampling_inputs(rng, shapes, collide=True)
    n, lq, m = 2, 13, 4
    cap = n * m * lq * 3 * 5  # the second level's size
    assert tds.sampling_methods(n, m, lq, shapes, "auto", cap) == ("gather", "onehot")

    def jax_core(method):
        return to_np(jds.ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw),
                                           method=method, sampling_dtype="bfloat16", onehot_cap=cap))

    want = jax_core("auto")
    got = tds.ms_deform_attn_core(t(value), shapes, t(loc), t(aw), method="auto", sampling_dtype="bfloat16",
                                  onehot_cap=cap)
    tol = SAMPLING_RTOL * np.abs(want).max()
    record(request, max_abs=max_abs(got, want), tol=tol)
    assert max_abs(got, want) <= tol
    for other in ("gather", "onehot", ("onehot", "gather")):
        assert max_abs(got, jax_core(other)) > 10 * tol, other


@pytest.fixture(scope="module")
def tiny_fast():
    jcfg = jconfig.fast_serving(jconfig.tiny_test_config())
    tcfg = tconfig.fast_serving(tconfig.tiny_test_config())
    params, model = model_pair(jcfg, tcfg, seed=0)
    return jcfg, tcfg, params, model


def test_pixel_decoder_fast_serving_matches_rba_tpu(tiny_fast, rng, request):
    """pixel_decoder_apply(dtype=bf16) at fast_serving on the tiny config: every output
    fp32 as in rba_tpu, within PD_FAST_RTOL of its largest element.  The decoder's bf16
    ops (input projection, position embedding, the first layer's projections, the
    lateral convs, the upsample's passes) round as rba_tpu's do; what is left is fp32
    rounding, which the fp32 FPN convs and GroupNorms carry to mask_features."""
    jcfg, tcfg, params, model = tiny_fast
    feats = {"res2": rng.randn(2, 16, 24, 32).astype(np.float32), "res3": rng.randn(2, 8, 12, 64).astype(np.float32)}
    want = jpd.pixel_decoder_apply(params["sem_seg_head"]["pixel_decoder"], jcfg.pixel_decoder,
                                   {k: jnp.asarray(v) for k, v in feats.items()}, jnp.bfloat16)
    with torch.no_grad():
        got = tpd.pixel_decoder_apply(model.sem_seg_head["pixel_decoder"], tcfg.pixel_decoder,
                                      {k: t(v) for k, v in feats.items()}, torch.bfloat16)
    pairs = [("mask_features", got[0], want[0]), ("encoder", got[1], want[1])] + [
        (f"ms{i}", g, w) for i, (g, w) in enumerate(zip(got[2], want[2]))]
    rel = {k: max_abs(g, to_np(w)) / np.abs(to_np(w)).max() for k, g, w in pairs}
    record(request, **{f"max_rel_{k}": v for k, v in rel.items()})
    for k, g, w in pairs:
        assert g.dtype == torch.float32 and str(w.dtype) == "float32", k
        assert rel[k] <= PD_FAST_RTOL, k


@pytest.mark.parametrize("hw", [(50, 70)])
def test_tiny_infer_rba_fast_serving_xla_matches_rba_tpu(tiny_fast, rng, request, hw):
    """maskformer_infer_rba(attention="xla") at fast_serving on the tiny config against
    rba_tpu's score map: within FAST_SCORE_TOL, and ulp_share >= 0.999."""
    jcfg, tcfg, params, model = tiny_fast
    img = (rng.rand(2, *hw, 3) * 255).astype(np.float32)
    want = to_np(jmf.maskformer_infer_rba(params, jcfg, jnp.asarray(img)))
    got = tmf.maskformer_infer_rba(model, tcfg, t(img), attention="xla")
    assert got.shape == (2, *hw) and np.isfinite(got.numpy()).all()
    record(request, max_abs=max_abs(got, want), ulp_share=ulp_share(got, want))
    assert max_abs(got, want) <= FAST_SCORE_TOL
    assert ulp_share(got, want) >= 0.999
