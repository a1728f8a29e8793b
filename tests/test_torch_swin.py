"""The port's Swin backbone against rba_tpu.models.swin at fp32 on the CPU (atol 1e-4).

Path 2 (``attention="fused_softmax"``, ``mlp_impl="fused"``) runs at a small config
whose two stages take the fused MLP (C = 128 and 256).  On the CPU the JAX package
takes neither kernel branch, so at fp32 the port's plain versions are held against
its XLA chain, the same function.  In bf16 the softmax branch is held against the
three steps composed from ``rba_tpu`` pieces, Pallas ``masked_softmax_bf16`` in
interpret mode in the middle, within one bf16 ulp of the largest output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.config import tiny_test_config as j_tiny
from rba_tpu.models import swin as jswin
from rba_tpu.ops.pallas.masked_softmax import masked_softmax_bf16
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.config import tiny_test_config
from rba_tpu_torch.convert import load_jax_params
from rba_tpu_torch.kernels import fused_mlp, masked_softmax, plain_versions
from rba_tpu_torch.models import swin as tswin
from tests.torch_port_common import max_abs, perturbed, record, t, to_jax

ATOL = 1e-4
# embed 128, two stages of two blocks, heads (4, 8), window 4: both stages take the fused MLP
PATH2_SWIN = dict(embed_dim=128, depths=(2, 2), num_heads=(4, 8), window_size=4, out_features=("res2", "res3"),
                  mlp_impl="fused")


def _jit_swin_fp32(scfg):
    """rba_tpu's fp32 ``swin_apply``, jitted: the same function, compiled once instead of
    op by op for each image shape."""
    return jax.jit(lambda p, x: jswin.swin_apply(p, scfg, x, compute_dtype=jnp.float32))


@pytest.fixture(scope="module")
def tiny_swin():
    params = perturbed(jswin.swin_init(jax.random.PRNGKey(0), j_tiny().swin), seed=1)
    model = tswin.Swin(tiny_test_config().swin)
    load_jax_params(model, params)
    return params, model


# (36, 52) is not a multiple of the stride-4 window grid, so every stage pads;
# batch 2 checks that windows of different images stay apart
@pytest.mark.parametrize("bhw", [(2, 36, 52), (1, 64, 64)], ids=["pad_b2", "even_b1"])
def test_swin_apply_matches(tiny_swin, rng, bhw):
    params, model = tiny_swin
    cfg = tiny_test_config().swin
    images = rng.randn(*bhw, 3).astype(np.float32)
    want = _jit_swin_fp32(j_tiny().swin)(to_jax(params), jnp.asarray(images))
    with torch.no_grad():
        got = tswin.swin_apply(model, cfg, t(images), compute_dtype=torch.float32)
    assert sorted(got) == sorted(want) == ["res2", "res3"]
    for name in got:
        assert max_abs(got[name], want[name]) < ATOL, name


@pytest.mark.parametrize("shift", [0, 2])
def test_block_matches(tiny_swin, rng, shift):
    """One block on a (1, 9, 13) map: padded to the 4-window grid, shifted or not."""
    params, model = tiny_swin
    x = rng.randn(1, 9, 13, 32).astype(np.float32)
    want = jswin.swin_block_apply(to_jax(params["layers"][0]["blocks"][1]), jnp.asarray(x), num_heads=2, ws=4,
                                  shift=shift, qk_scale=None)
    with torch.no_grad():
        got = tswin.swin_block_apply(model.layers[0].blocks[1], t(x), 2, 4, shift, None)
    assert max_abs(got, want) < ATOL


def test_patch_merging_odd_size(tiny_swin, rng):
    params, model = tiny_swin
    x = rng.randn(2, 7, 9, 32).astype(np.float32)
    want = jswin._patch_merging(to_jax(params["layers"][0]["downsample"]), jnp.asarray(x))
    with torch.no_grad():
        got = tswin._patch_merging(model.layers[0].downsample, t(x))
    assert got.shape == (2, 4, 5, 64)
    assert max_abs(got, want) < ATOL


def test_plain_flag_is_the_same_function_on_cpu(tiny_swin, rng):
    _, model = tiny_swin
    x = t(rng.randn(1, 32, 32, 3))
    cfg = tiny_test_config().swin
    with torch.no_grad():
        a = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32)
    with torch.no_grad(), plain_versions():
        b = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32)
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)


def test_cached_constants_serve_inference_and_grad_mode(tiny_swin, rng):
    """The window constants cached by a call under inference_mode also serve a later
    call that tracks gradients (the model's parameters require grad), through the
    plain-PyTorch branch that training takes (Kernel A's wrapper refuses gradients)."""
    _, model = tiny_swin
    x = t(rng.randn(1, 36, 44, 3))  # a shape no other test of this file uses
    cfg = tiny_test_config().swin
    with torch.inference_mode():
        a = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32, attention="xla")
    b = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32, attention="xla")
    for name in a:
        assert b[name].requires_grad
        torch.testing.assert_close(a[name], b[name].detach(), rtol=0, atol=0)


@pytest.fixture(scope="module")
def path2_swin():
    jcfg = dataclasses.replace(jconfig.SwinConfig(), **PATH2_SWIN)
    tcfg = dataclasses.replace(tconfig.SwinConfig(), **PATH2_SWIN)
    params = perturbed(jswin.swin_init(jax.random.PRNGKey(2), jcfg), seed=4)
    model = tswin.Swin(tcfg)
    load_jax_params(model, params)
    return jcfg, tcfg, params, model


def test_path2_swin_apply_matches(path2_swin, rng, request):
    """swin_apply through Kernel C's branch and Kernel D on a 32x32 image, fp32."""
    jcfg, tcfg, params, model = path2_swin
    images = rng.randn(1, 32, 32, 3).astype(np.float32)
    want = _jit_swin_fp32(jcfg)(to_jax(params), jnp.asarray(images))
    before = fused_mlp.fused_mlp_residual.launches, masked_softmax.masked_softmax.launches
    with torch.no_grad():
        got = tswin.swin_apply(model, tcfg, t(images), compute_dtype=torch.float32, attention="fused_softmax")
    # the CPU runs the plain versions: no launch is counted
    assert (fused_mlp.fused_mlp_residual.launches, masked_softmax.masked_softmax.launches) == before
    assert sorted(got) == sorted(want) == ["res2", "res3"]
    record(request, **{f"max_abs_{name}": max_abs(got[name], want[name]) for name in got})
    for name in got:
        assert max_abs(got[name], want[name]) < ATOL, name


@pytest.mark.parametrize("shift", [0, 2])
def test_path2_block_matches(path2_swin, rng, request, shift):
    """One stage-0 block (C = 128) on a padded (1, 9, 13) map: the softmax branch and
    the fused MLP tail against rba_tpu's block, fp32."""
    _, _, params, model = path2_swin
    x = rng.randn(1, 9, 13, 128).astype(np.float32)
    want = jswin.swin_block_apply(to_jax(params["layers"][0]["blocks"][1]), jnp.asarray(x), num_heads=4, ws=4,
                                  shift=shift, qk_scale=None, mlp_impl="fused")
    blk = model.layers[0].blocks[1]
    assert fused_mlp.beneficial(9 * 13, 128)
    with torch.no_grad():
        got = tswin.swin_block_apply(blk, t(x), 4, 4, shift, None, attention="fused_softmax", mlp_impl="fused")
    record(request, max_abs=max_abs(got, want))
    assert max_abs(got, want) < ATOL


def test_mlp_tail_is_unfused_when_tracking_gradients(path2_swin, rng):
    """Kernel D is inference only, as in rba_tpu: with gradients tracked the unfused
    chain runs, and the output carries a gradient.  The attention is the training
    branch, "xla" (Kernel C's wrapper refuses gradients)."""
    _, _, _, model = path2_swin
    x = t(rng.randn(1, 8, 8, 128))
    blk = model.layers[0].blocks[0]
    y = tswin.swin_block_apply(blk, x, 4, 4, 0, None, attention="xla", mlp_impl="fused")
    assert y.requires_grad
    with torch.no_grad():
        torch.testing.assert_close(
            tswin.swin_block_apply(blk, x, 4, 4, 0, None, attention="xla", mlp_impl="fused"),
            y.detach(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_branch_bf16_matches_rba_tpu_steps(rng, request, masked):
    """The bf16 softmax branch (q·kᵀ, Kernel C, · v) against the JAX package's three
    steps: the einsum of ``rba_tpu/models/swin.py:265``, ``masked_softmax_bf16`` in
    interpret mode, the einsum of ``:326-327``.  Within one bf16 ulp of the largest
    output."""
    nh, hd, ws, hp, wp, b = 4, 32, 4, 8, 12, 2
    n, c = ws * ws, nh * hd
    nw = (hp // ws) * (wp // ws)
    qkv = np.asarray(jnp.asarray(rng.randn(b * nw, n, 3 * c), jnp.bfloat16).astype(jnp.float32))
    bias = rng.randn(nh, n, n).astype(np.float32)
    mask = jswin.shifted_window_mask(hp, wp, ws, ws // 2) if masked else None
    scale = hd**-0.5

    jq = jnp.asarray(qkv, jnp.bfloat16).reshape(b * nw, n, 3, nh, hd)
    q, k, v = jq[..., 0, :, :], jq[..., 1, :, :], jq[..., 2, :, :]
    s = jnp.einsum("wqhd,wkhd->whqk", q * scale, k, preferred_element_type=jnp.float32)
    p = masked_softmax_bf16(s.reshape(b, nw, nh, n, n), jnp.asarray(bias), mask, out_dtype=jnp.bfloat16,
                            interpret=True).reshape(b * nw, nh, n, n)
    want = jnp.einsum("whqk,wkhd->wqhd", p, v, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32)).reshape(b * nw, n, c)

    got = tswin.softmax_attention(t(qkv).bfloat16(), t(bias), None if mask is None else t(mask), nh, scale)
    assert got.dtype == torch.bfloat16
    record(request, max_abs=max_abs(got.float(), want), tol=2.0**-7 * np.abs(want).max())
    assert max_abs(got.float(), want) <= 2.0**-7 * np.abs(want).max()


def test_unknown_attention_raises(tiny_swin):
    _, model = tiny_swin
    with pytest.raises(ValueError, match="attention"):
        tswin.swin_apply(model, tiny_test_config().swin, torch.zeros(1, 32, 32, 3), compute_dtype=torch.float32,
                         attention="sdpa")
