"""The gradient of ``ops/deform_sampling.ms_deform_attn_core`` with respect to the values,
the sampling locations and the attention weights, against ``jax.grad`` of
``rba_tpu.ops.deform_sampling.ms_deform_attn_core`` (its custom VJPs), within 1e-5 of
the largest: the gather form and the one-hot form at fp32, and the one-hot form at
``sampling_dtype="bfloat16"``, whose backward runs at fp32 (``OneHotLevel``), as
rba_tpu's ``_onehot_level_bwd`` does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.ops import deform_sampling as jds
from rba_tpu_torch.ops import deform_sampling as tds
from tests.torch_port_common import t

TOL = 1e-5  # relative to each gradient's largest magnitude
SHAPES = [(6, 8), (3, 4)]
N, M, D, LQ, P = 2, 2, 4, 7, 3


def _inputs(seed):
    rs = np.random.RandomState(seed)
    s = sum(h * w for h, w in SHAPES)
    value = rs.randn(N, s, M, D).astype(np.float32)
    loc = rs.uniform(-0.1, 1.1, (N, LQ, M, len(SHAPES), P, 2)).astype(np.float32)  # some corners outside
    attn = rs.rand(N, LQ, M, len(SHAPES), P).astype(np.float32)
    cot = rs.randn(N, LQ, M * D).astype(np.float32)
    return value, loc, attn, cot


@pytest.mark.parametrize("method,dtype", [("gather", "float32"), ("onehot", "float32"), ("onehot", "bfloat16")])
def test_gradients_match_rba_tpu(method, dtype):
    value, loc, attn, cot = _inputs(len(method) + len(dtype))

    def jloss(v, l, a):
        out = jds.ms_deform_attn_core(v, SHAPES, l, a, method=method, sampling_dtype=dtype)
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (value, loc, attn)))
    tv, tl, ta = (t(x).requires_grad_() for x in (value, loc, attn))
    out = tds.ms_deform_attn_core(tv, SHAPES, tl, ta, method=method, sampling_dtype=dtype)
    (out * t(cot)).sum().backward()
    for g, w in zip((tv.grad, tl.grad, ta.grad), want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TOL * np.abs(w).max()


def test_onehot_bf16_forward_unchanged_by_the_function():
    """The autograd.Function's forward is the one-hot level bit for bit, with or without
    gradients tracked."""
    value, loc, attn, _ = _inputs(9)
    h, w = SHAPES[0]
    v = t(value[:, : h * w]).reshape(N, h, w, M, D)
    l, a = t(loc[:, :, :, 0]), t(attn[:, :, :, 0])
    with torch.no_grad():
        want = tds._onehot_level(v, l, a)
    got = tds.OneHotLevel.apply(v.requires_grad_(), l, a)
    assert torch.equal(got.detach(), want)
