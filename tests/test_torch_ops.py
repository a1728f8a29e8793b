"""The port's basic ops against rba_tpu's, at fp32 on the CPU (rtol 1e-5, atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.models import position_encoding as jpos
from rba_tpu.ops import deform_sampling as jds
from rba_tpu.ops import nn as jnn
from rba_tpu.ops import resize as jrs
from rba_tpu_torch.models import position_encoding as tpos
from rba_tpu_torch.ops import deform_sampling as tds
from rba_tpu_torch.ops import nn as tnn
from rba_tpu_torch.ops import resize as trs
from tests.torch_port_common import t

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("bias", [True, False])
def test_linear(rng, bias):
    x = rng.randn(2, 5, 24).astype(np.float32)
    k = rng.randn(24, 40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    params = {"kernel": jnp.asarray(k), **({"bias": jnp.asarray(b)} if bias else {})}
    want = jnn.linear(params, jnp.asarray(x))
    _close(tnn.linear(t(x), t(k.T), t(b) if bias else None), want)


def test_layer_norm(rng):
    x = (rng.randn(3, 7, 48) * 3 + 1).astype(np.float32)
    g, b = rng.randn(48).astype(np.float32), rng.randn(48).astype(np.float32)
    want = jnn.layer_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(b)}, jnp.asarray(x))
    _close(tnn.layer_norm(t(x), t(g), t(b)), want)


def test_group_norm_nhwc(rng):
    x = (rng.randn(2, 6, 9, 64) * 2 + 0.5).astype(np.float32)
    g, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = jnn.group_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(b)}, jnp.asarray(x), num_groups=32)
    _close(tnn.group_norm(t(x), t(g), t(b), num_groups=32), want)


@pytest.mark.parametrize("k", [1, 3])
def test_conv2d_same(rng, k):
    x = rng.randn(2, 7, 10, 16).astype(np.float32)
    w = (rng.randn(k, k, 16, 24) * 0.2).astype(np.float32)  # HWIO
    b = rng.randn(24).astype(np.float32)
    want = jnn.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    if k == 3:  # the row-tiled TPU variant computes the same conv
        want_rt = jnn.conv2d_3x3_rowtiled({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
        _close(np.asarray(want_rt), want)
    _close(tnn.conv2d(t(x), t(w.transpose(3, 2, 0, 1)), t(b)), want)


def test_conv2d_rejects_even_kernels():
    with pytest.raises(ValueError):
        tnn.conv2d(torch.zeros(1, 4, 4, 3), torch.zeros(5, 3, 2, 2))


def test_mlp_apply(rng):
    dims = [16, 32, 32, 8]
    ks = [rng.randn(dims[i], dims[i + 1]).astype(np.float32) * 0.3 for i in range(3)]
    bs = [rng.randn(dims[i + 1]).astype(np.float32) for i in range(3)]
    x = rng.randn(2, 5, 16).astype(np.float32)
    want = jnn.mlp_apply({"layers": [{"kernel": jnp.asarray(k), "bias": jnp.asarray(b)} for k, b in zip(ks, bs)]},
                         jnp.asarray(x))
    layers = []
    for k, b in zip(ks, bs):
        lin = torch.nn.Linear(k.shape[0], k.shape[1])
        with torch.no_grad():
            lin.weight.copy_(t(k.T))
            lin.bias.copy_(t(b))
        layers.append(lin)
    with torch.no_grad():
        _close(tnn.mlp_apply(layers, t(x)), want)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(20, 36), (5, 7), (11, 64)])
def test_resize_bilinear(rng, align_corners, out_hw):
    x = rng.randn(2, 3, 10, 16).astype(np.float32)
    want = jrs.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align_corners)
    _close(trs.resize_bilinear(t(x), out_hw, align_corners=align_corners), want)


@pytest.mark.parametrize("out_hw", [(16, 24), (3, 5), (13, 19)])
def test_resize_bilinear_nhwc(rng, out_hw):
    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    want = jrs.resize_bilinear_nhwc(jnp.asarray(x), out_hw)
    _close(trs.resize_bilinear_nhwc(t(x), out_hw), want)


@pytest.mark.parametrize("hwc", [(4, 6, 64), (8, 16, 256), (3, 5, 32)])
def test_sine_pos_embed(hwc):
    h, w, c = hwc
    _close(tpos.sine_pos_embed(h, w, c), jpos.sine_pos_embed(h, w, c))


@pytest.mark.parametrize("method", ["auto", "gather", "gather_scatter"])
def test_ms_deform_attn_core(rng, method):
    """Two levels, sample points partly outside the map (zero padding)."""
    n, m, d, lq, p = 2, 4, 8, 13, 3
    shapes = [(6, 9), (3, 5)]
    s = sum(h * w for h, w in shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (n, lq, m, len(shapes), p, 2)).astype(np.float32)
    aw = rng.rand(n, lq, m, len(shapes), p).astype(np.float32)
    aw /= aw.sum(axis=(-2, -1), keepdims=True)
    want = jds.ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw), method=method)
    _close(tds.ms_deform_attn_core(t(value), shapes, t(loc), t(aw)), want)
