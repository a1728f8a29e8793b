"""The plain version of the fused-MLP kernel (Kernel D) against the Pallas kernel it
replaces, ``fused_mlp_residual`` in interpret mode on the CPU, and the port's copy
of its dispatch rule against ``rba_tpu``'s.

Inputs are drawn as ``tests/test_fused_mlp.py`` ``_make`` draws them; the bounds
are that file's: rtol = atol = 2e-5 in fp32, 2e-2 in bf16.

In bf16 the 2e-2 bound holds for at least 99.9 % of the elements, and every
element is within one bf16 ulp of the largest output.  The plain version rounds
``fc1(y) + b1`` to bf16 before the gelu, as the Pallas source writes it (a bf16
add); XLA on the CPU folds that add into the gelu's fp32 upcast and drops the
rounding.  That moves about a fifth to two fifths of the outputs by one bf16
ulp (measured when written: 81 % equal at C = 128, 71 % at 256, 61 % at 512; the
same placement without that rounding matched 99.99 %).  Where the fc2 output
|o| reaches 4, one ulp of it (0.03125) exceeds 2e-2 on an output near 0: 1 of
262144 elements at (1024, 256) and 14 of 131072 at (256, 512), none at C = 128.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.ops.pallas import fused_mlp as jfm
from rba_tpu_torch.kernels import fused_mlp as tfm
from tests.torch_port_common import record, t

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_SHARE = 0.999  # least share of bf16 elements within the 2e-2 bound


def _make(t_, c, seed):
    """x (t, c) and the LayerNorm / fc1 / fc2 parameters, as ``_make`` of the JAX test."""
    rng = np.random.RandomState(seed)
    hid = 4 * c
    x = rng.randn(t_, c).astype(np.float32) * 2.0
    gamma = (rng.randn(c) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    w1 = (rng.randn(c, hid) * 0.05).astype(np.float32)  # JAX layout (in, out)
    b1 = (rng.randn(hid) * 0.02).astype(np.float32)
    w2 = (rng.randn(hid, c) * 0.05).astype(np.float32)
    b2 = (rng.randn(c) * 0.02).astype(np.float32)
    return x, gamma, beta, w1, b1, w2, b2


def _compare(request, x, gamma, beta, w1, b1, w2, b2, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfm.fused_mlp_residual(
        jnp.asarray(x, jdt), {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
        {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)}, {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)},
        interpret=True,
    )
    # the port's parameters in nn.Linear's (out, in) layout
    got = tfm.fused_mlp_residual(t(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))).to(tdt), t(gamma), t(beta),
                                 t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    assert got.dtype == tdt and got.shape == x.shape
    got, want, tol = got.float().numpy(), np.asarray(want.astype(jnp.float32)), TOL[dtype]
    d = np.abs(got - want)
    record(request, max_abs=d.max(), share_within_tol=(d <= tol + tol * np.abs(want)).mean(),
           max_abs_output=np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert (d <= tol + tol * np.abs(want)).mean() >= BF16_SHARE
        assert d.max() <= 2.0**-7 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_c", [(512, 128), (1024, 256), (256, 512), (1000, 128)],
                         ids=["T512_C128", "T1024_C256", "T256_C512", "T1000_C128"])
def test_plain_matches_pallas(request, t_c, dtype):
    _compare(request, *_make(*t_c, seed=3), dtype)


def test_leading_dims(request):
    """(B, H, W, C) activations: the tokens are the leading dims flattened."""
    x, *params = _make(2 * 8 * 32, 128, seed=1)
    _compare(request, x.reshape(2, 8, 32, 128), *params, "float32")


def test_dispatch_rule_matches_rba_tpu():
    for t_ in (1, 64, 1000, 32768, 131072):
        for c in (64, 96, 128, 192, 256, 384, 512, 640, 1024):
            assert tfm.supports(t_, c) == jfm.supports(t_, c), (t_, c)
            assert tfm.beneficial(t_, c) == jfm.beneficial(t_, c), (t_, c)


@pytest.mark.parametrize("bad", ["c192", "c1024", "x_fp16", "w1_layout", "w2_bf16", "x_strided", "x_misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    c = 128
    x = torch.zeros(8, c)
    p = dict(gamma=torch.ones(c), beta=torch.zeros(c), w1=torch.zeros(4 * c, c), b1=torch.zeros(4 * c),
             w2=torch.zeros(c, 4 * c), b2=torch.zeros(c))
    if bad in ("c192", "c1024"):
        c = int(bad[1:])
        x = torch.zeros(8, c)
        p = dict(gamma=torch.ones(c), beta=torch.zeros(c), w1=torch.zeros(4 * c, c), b1=torch.zeros(4 * c),
                 w2=torch.zeros(c, 4 * c), b2=torch.zeros(c))
    elif bad == "x_fp16":
        x = x.half()
    elif bad == "w1_layout":
        p["w1"] = torch.zeros(c, 4 * c)  # JAX's (in, out) layout
    elif bad == "w2_bf16":
        p["w2"] = p["w2"].bfloat16()
    elif bad == "x_misaligned":  # contiguous, but 4 bytes past a 16-byte boundary
        x = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    else:
        x = torch.zeros(8, 2 * c)[:, :c]
    with pytest.raises((ValueError, TypeError)):
        tfm._check(x, **p)
