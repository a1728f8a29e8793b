"""The plain version of the window-attention kernel against the Pallas kernels it
replaces, run in interpret mode on the CPU (rtol 1e-4, atol 1e-5, fp32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.models import swin as jswin
from rba_tpu.ops.pallas.window_attention import window_attention_fused_v2, window_attention_fused_v3
from rba_tpu_torch.kernels import window_attention as twa
from rba_tpu_torch.models import swin as tswin
from tests.torch_port_common import t

TOL = dict(rtol=1e-4, atol=1e-5)

# (ws, nh, hd, hp, wp): N = 16 at hd 16 (tiny config), N = 144 at hd 32 (Swin-B/L)
SHAPES = [(4, 2, 16, 8, 12), (12, 2, 32, 24, 24)]


def _inputs(rng, ws, nh, hd, hp, wp, masked):
    b, n = 2, ws * ws
    nw = (hp // ws) * (wp // ws)
    qkv = rng.randn(b, nw, n, 3 * nh * hd).astype(np.float32)
    bias = rng.randn(nh, n, n).astype(np.float32)
    mask = jswin.shifted_window_mask(hp, wp, ws, ws // 2) if masked else None
    return qkv, bias, mask, hd**-0.5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["N16", "N144"])
def test_plain_matches_pallas_v2(rng, shape, masked):
    ws, nh, hd, hp, wp = shape
    qkv, bias, mask, scale = _inputs(rng, ws, nh, hd, hp, wp, masked)
    want = window_attention_fused_v2(jnp.asarray(qkv), jnp.asarray(bias), mask, nh, scale, interpret=True)
    b, nw, n, c3 = qkv.shape
    got = twa.window_attention(t(qkv.reshape(b * nw, n, c3)), t(bias), None if mask is None else t(mask), nh, scale)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["N16", "N144"])
def test_plain_matches_pallas_v3(rng, shape, masked):
    ws, nh, hd, hp, wp = shape
    qkv, bias, mask, scale = _inputs(rng, ws, nh, hd, hp, wp, masked)
    b, nw, n, c3 = qkv.shape
    split = qkv.reshape(b, nw, n, 3, nh, hd)
    q, k, v = (np.ascontiguousarray(split[:, :, :, i].transpose(0, 1, 3, 2, 4)) for i in range(3))  # (B, nW, nh, N, hd)
    want = window_attention_fused_v3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), mask,
                                     scale, interpret=True)
    want = np.asarray(want).transpose(0, 1, 3, 2, 4).reshape(b * nw, n, nh * hd)
    got = twa.window_attention_reference(t(qkv.reshape(b * nw, n, c3)), t(bias),
                                         None if mask is None else t(mask), nh, scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("hw_ws_shift", [(8, 12, 4, 2), (24, 36, 12, 6), (12, 12, 12, 6)])
def test_window_constants_match(hw_ws_shift):
    hp, wp, ws, shift = hw_ws_shift
    np.testing.assert_array_equal(tswin.shifted_window_mask(hp, wp, ws, shift),
                                  jswin.shifted_window_mask(hp, wp, ws, shift))
    np.testing.assert_array_equal(tswin.relative_position_index(ws), jswin.relative_position_index(ws))


def test_bf16_plain_keeps_fp32_math(rng):
    """In bf16 the plain version widens q, k, v to fp32 and rounds only the output."""
    qkv, bias, mask, scale = _inputs(rng, 4, 2, 16, 8, 12, True)
    x = t(qkv.reshape(-1, 16, 96)).bfloat16()
    got = twa.window_attention_reference(x, t(bias), t(mask), 2, scale)
    want = twa.window_attention_reference(x.float(), t(bias), t(mask), 2, scale).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["hd64", "n200", "mask_shape", "bias_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    n, nh, hd = 16, 2, 16
    qkv = torch.zeros(4, n, 3 * nh * hd)
    bias = torch.zeros(nh, n, n)
    mask = None
    if bad == "hd64":
        qkv = torch.zeros(4, n, 3 * nh * 64)
    elif bad == "n200":
        qkv, bias = torch.zeros(4, 200, 3 * nh * hd), torch.zeros(nh, 200, 200)
    elif bad == "mask_shape":
        mask = torch.zeros(3, n, n)
    else:
        bias = bias.double()
    with pytest.raises((ValueError, TypeError)):
        twa._check(qkv, bias, mask, nh)
