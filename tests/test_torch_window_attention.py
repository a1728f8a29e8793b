"""The plain version of the window-attention kernel against the Pallas kernels it
replaces, run in interpret mode on the CPU.

fp32: rtol 1e-4, atol 1e-5.  bf16 (q, k, v in bf16, as the bf16 backbone serves
them): within one bf16 ulp of the largest output, the bound ``chip_smoke.py``
holds the kernel to, and at least 99.9 % of the elements within one bf16 ulp of
their own value.  The second bound is the one that tells the probabilities'
rounding apart: with fp32 probabilities, as the port had them before, 88-92 % of
the elements met it at these shapes while the largest difference still stayed
within one ulp of the largest output.  The bf16 cases of the v3 test assert that
the former placement misses the second bound, and record the largest difference
of both placements and their share within the per-element bound (properties
``max_abs_vs_v3_*`` and ``ulp_share_*`` of the test case in a ``--junitxml`` report).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.models import swin as jswin
from rba_tpu.ops.pallas.window_attention import window_attention_fused_v2, window_attention_fused_v3
from rba_tpu_torch.kernels import window_attention as twa
from rba_tpu_torch.models import swin as tswin
from tests.torch_port_common import record, t

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0**-7  # one bf16 ulp relative to the value, at most
BF16_SHARE = 0.999  # least share of elements within one ulp of their own value

# (ws, nh, hd, hp, wp): N = 16 at hd 16 (tiny config), N = 144 at hd 32 (Swin-B/L)
SHAPES = [(4, 2, 16, 8, 12), (12, 2, 32, 24, 24)]
# each shape in fp32 and with bf16 q/k/v
CASES = [(s, d) for d in (np.float32, jnp.bfloat16) for s in SHAPES]
CASE_IDS = ["N16", "N144", "N16_bf16", "N144_bf16"]


def _inputs(rng, ws, nh, hd, hp, wp, masked, dtype=np.float32):
    b, n = 2, ws * ws
    nw = (hp // ws) * (wp // ws)
    qkv = np.asarray(jnp.asarray(rng.randn(b, nw, n, 3 * nh * hd), dtype).astype(jnp.float32))
    bias = rng.randn(nh, n, n).astype(np.float32)
    mask = jswin.shifted_window_mask(hp, wp, ws, ws // 2) if masked else None
    return qkv, bias, mask, hd**-0.5


def _torch(a, dtype):
    x = t(a)
    return x.bfloat16() if dtype == jnp.bfloat16 else x


def bf16_ulp_share(got, want) -> float:
    """Share of the elements of ``got`` within one bf16 ulp of ``want`` (plus 1e-6)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6).mean())


def _check(got, want, dtype):
    got = got.float().numpy().reshape(want.shape)
    if dtype == jnp.bfloat16:
        assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()
        assert bf16_ulp_share(got, want) >= BF16_SHARE
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", CASES, ids=CASE_IDS)
def test_plain_matches_pallas_v2(rng, shape, masked):
    (ws, nh, hd, hp, wp), dtype = shape
    qkv, bias, mask, scale = _inputs(rng, ws, nh, hd, hp, wp, masked, dtype)
    want = window_attention_fused_v2(jnp.asarray(qkv, dtype), jnp.asarray(bias), mask, nh, scale, interpret=True)
    b, nw, n, c3 = qkv.shape
    got = twa.window_attention(_torch(qkv.reshape(b * nw, n, c3), dtype), t(bias),
                               None if mask is None else t(mask), nh, scale)
    _check(got, np.asarray(want.astype(jnp.float32)), dtype)


def _pallas_v3(qkv, bias, mask, nh, hd, scale, dtype):
    """Pallas v3 in interpret mode on the fused (B, nW, N, 3C) qkv, as (B·nW, N, C) fp32."""
    b, nw, n, _ = qkv.shape
    split = qkv.reshape(b, nw, n, 3, nh, hd)
    q, k, v = (jnp.asarray(split[:, :, :, i].transpose(0, 1, 3, 2, 4), dtype) for i in range(3))  # (B, nW, nh, N, hd)
    want = window_attention_fused_v3(q, k, v, jnp.asarray(bias), mask, scale, interpret=True)
    return np.asarray(want.astype(jnp.float32)).transpose(0, 1, 3, 2, 4).reshape(b * nw, n, nh * hd)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", CASES, ids=CASE_IDS)
def test_plain_matches_pallas_v3(rng, request, shape, masked):
    (ws, nh, hd, hp, wp), dtype = shape
    qkv, bias, mask, scale = _inputs(rng, ws, nh, hd, hp, wp, masked, dtype)
    want = _pallas_v3(qkv, bias, mask, nh, hd, scale, dtype)
    b, nw, n, c3 = qkv.shape
    x, m = _torch(qkv.reshape(b * nw, n, c3), dtype), None if mask is None else t(mask)
    got = twa.window_attention_reference(x, t(bias), m, nh, scale)
    _check(got, want, dtype)
    if dtype == jnp.bfloat16:
        # the port before the repair: fp32 probabilities, only the output rounded
        before = twa.window_attention_reference(x.float(), t(bias), m, nh, scale).bfloat16().float().numpy()
        after = got.float().numpy()
        record(request, max_abs_vs_v3_after=np.abs(after - want).max(), max_abs_vs_v3_before=np.abs(before - want).max(),
               ulp_share_after=bf16_ulp_share(after, want), ulp_share_before=bf16_ulp_share(before, want),
               tol=BF16_ULP * np.abs(want).max())
        assert bf16_ulp_share(before, want) < 0.95


def tensor_core_order(qkv, bias, mask, nh, scale):
    """The arithmetic of the bf16 tensor-core kernel, in its order, in plain torch:
    bf16 q and k into an fp32 product, then ``· scale``, + bias, + mask, the softmax
    with a division by the row sum, the probabilities rounded to bf16, the fp32
    ``· v`` sum rounded to bf16.  The plain version (and Pallas) scale q before the
    product instead."""
    bw, n, c3 = qkv.shape
    hd = c3 // 3 // nh
    q, k, v = qkv.bfloat16().float().reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None]).reshape(bw, nh, n, n)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).bfloat16().float()
    return torch.matmul(p, v).permute(0, 2, 1, 3).reshape(bw, n, nh * hd).bfloat16()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["N16", "N144"])
def test_tensor_core_order_matches_pallas_v3(rng, request, shape, masked):
    """Scaling the fp32 product instead of q costs nothing measurable: the kernel's
    order, emulated, meets the bf16 bounds against Pallas v3 and against the plain
    version (records the largest difference and the per-element share of both)."""
    ws, nh, hd, hp, wp = shape
    qkv, bias, mask, scale = _inputs(rng, ws, nh, hd, hp, wp, masked, jnp.bfloat16)
    want = _pallas_v3(qkv, bias, mask, nh, hd, scale, jnp.bfloat16)
    b, nw, n, c3 = qkv.shape
    x, m = t(qkv.reshape(b * nw, n, c3)).bfloat16(), None if mask is None else t(mask)
    got = tensor_core_order(x, t(bias), m, nh, scale)
    plain = twa.window_attention_reference(x, t(bias), m, nh, scale).float().numpy().reshape(want.shape)
    emulated = got.float().numpy().reshape(want.shape)
    record(request, max_abs_vs_v3=np.abs(emulated - want).max(), ulp_share_vs_v3=bf16_ulp_share(emulated, want),
           max_abs_vs_plain=np.abs(emulated - plain).max(), ulp_share_vs_plain=bf16_ulp_share(emulated, plain))
    _check(got, want, jnp.bfloat16)
    _check(got, plain, jnp.bfloat16)


@pytest.mark.parametrize("hw_ws_shift", [(8, 12, 4, 2), (24, 36, 12, 6), (12, 12, 12, 6)])
def test_window_constants_match(hw_ws_shift):
    hp, wp, ws, shift = hw_ws_shift
    np.testing.assert_array_equal(tswin.shifted_window_mask(hp, wp, ws, shift),
                                  jswin.shifted_window_mask(hp, wp, ws, shift))
    np.testing.assert_array_equal(tswin.relative_position_index(ws), jswin.relative_position_index(ws))


def test_bf16_plain_keeps_fp32_math(rng):
    """In bf16 the plain version widens q, k, v to fp32, computes the scores, the
    softmax and the ``· v`` sum in fp32, and rounds twice: the probabilities before
    the ``· v`` sum, as Pallas v3 does, and the output."""
    nh, hd = 2, 32
    qkv, bias, mask, scale = _inputs(rng, 12, nh, hd, 24, 24, True, jnp.bfloat16)
    b, nw, n, c3 = qkv.shape
    x = t(qkv.reshape(b * nw, n, c3)).bfloat16()
    got = twa.window_attention_reference(x, t(bias), t(mask), nh, scale)
    assert got.dtype == torch.bfloat16

    q, k, v = x.float().reshape(b * nw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q * scale, k.transpose(-1, -2)) + t(bias)
    s = (s.reshape(b, nw, nh, n, n) + t(mask)[None, :, None]).reshape(b * nw, nh, n, n)
    p = torch.softmax(s, dim=-1)
    placed = torch.matmul(p.bfloat16().float(), v).permute(0, 2, 1, 3).reshape(b * nw, n, nh * hd).bfloat16()
    torch.testing.assert_close(got, placed, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["hd64", "n200", "mask_shape", "bias_dtype", "qkv_misaligned"])
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
    elif bad == "qkv_misaligned":  # contiguous, but 4 bytes past a 16-byte boundary
        qkv = torch.zeros(qkv.numel() + 1)[1:].view(qkv.shape)
    else:
        bias = bias.double()
    with pytest.raises((ValueError, TypeError)):
        twa._check(qkv, bias, mask, nh)


def test_wrapper_refuses_gradients():
    """Kernel A has no gradient: with grad mode on and an input that requires one, the
    wrapper's dispatch raises (on the CPU too, where it would run the plain version)
    instead of returning a result cut off from the graph; without grad mode it runs."""
    qkv = torch.randn(4, 16, 3 * 2 * 16, requires_grad=True)
    bias = torch.zeros(2, 16, 16)
    with pytest.raises(NotImplementedError, match="no gradient"):
        twa.window_attention(qkv, bias, None, 2, 0.25)
    with torch.no_grad():
        out = twa.window_attention(qkv, bias, None, 2, 0.25)
    assert torch.equal(out, twa.window_attention_reference(qkv.detach(), bias, None, 2, 0.25))
