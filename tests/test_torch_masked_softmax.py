"""The plain version of the masked-softmax kernel (Kernel C) against the Pallas kernel
it replaces, ``masked_softmax_bf16`` in interpret mode on the CPU.

Shapes as ``tests/test_window_attention_kernel.py::test_masked_softmax_kernel_matches_xla``:
N = 144, (nW, nh) = (12, 4) and (6, 16), scores scaled by 3, random -100 masks;
batch 2, so that windows of the second image take the mask from the first.
bf16 output: every element within one bf16 ulp of the Pallas value: rtol 2**-7,
and atol 2**-133, the spacing of bf16's subnormals, where a probability of about
1e-40 behind a -100 mask sits (3 elements of each masked case differ there by
that one ulp).  The share of exact matches is asserted too (measured when
written: 0.99998 or more; the other elements differ by one ulp).  fp32 output:
rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.ops.pallas.masked_softmax import masked_softmax_bf16
from rba_tpu_torch.kernels import masked_softmax as tms
from tests.torch_port_common import record, t

N = 144
EXACT_SHARE = 0.99  # least share of bf16 probabilities equal to the Pallas kernel's


def _inputs(rng, nw, nh, masked, b=2):
    s = (rng.randn(b, nw, nh, N, N) * 3).astype(np.float32)
    bias = rng.randn(nh, N, N).astype(np.float32)
    mask = ((rng.rand(nw, N, N) > 0.5) * -100.0).astype(np.float32) if masked else None
    return s, bias, mask


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("nw_nh", [(12, 4), (6, 16)], ids=["nW12_nh4", "nW6_nh16"])
def test_plain_matches_pallas(rng, request, nw_nh, masked, out_dtype):
    nw, nh = nw_nh
    s, bias, mask = _inputs(rng, nw, nh, masked)
    want = masked_softmax_bf16(jnp.asarray(s), jnp.asarray(bias), mask, out_dtype=getattr(jnp, out_dtype),
                               interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    b = s.shape[0]
    got = tms.masked_softmax(t(s.reshape(b * nw, nh, N, N)), t(bias), None if mask is None else t(mask),
                             getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (b * nw, nh, N, N)
    got = got.float().numpy().reshape(want.shape)
    record(request, max_abs=np.abs(got - want).max(), exact_share=(got == want).mean())
    if out_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-133)
        assert (got == want).mean() >= EXACT_SHARE
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bad", ["n200", "bias_shape", "mask_nw", "scores_bf16", "out_fp16"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    n, nh = 16, 2
    scores, bias, mask, out_dtype = torch.zeros(4, nh, n, n), torch.zeros(nh, n, n), None, torch.bfloat16
    if bad == "n200":
        scores, bias = torch.zeros(4, nh, 200, 200), torch.zeros(nh, 200, 200)
    elif bad == "bias_shape":
        bias = torch.zeros(nh + 1, n, n)
    elif bad == "mask_nw":
        mask = torch.zeros(3, n, n)
    elif bad == "scores_bf16":
        scores = scores.bfloat16()
    else:
        out_dtype = torch.float16
    with pytest.raises((ValueError, TypeError)):
        tms._check(scores, bias, mask, out_dtype)


def test_wrapper_refuses_gradients():
    """Kernel C has no gradient: with grad mode on and an input that requires one (the
    bias table, here), the wrapper's dispatch raises, on the CPU too; under no_grad it
    runs the plain version."""
    scores = torch.randn(4, 2, 16, 16)
    bias = torch.zeros(2, 16, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tms.masked_softmax(scores, bias, None)
    with torch.no_grad():
        out = tms.masked_softmax(scores, bias, None, torch.float32)
    assert torch.equal(out, tms.masked_softmax_reference(scores, bias.detach(), None, torch.float32))
