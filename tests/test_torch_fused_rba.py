"""The plain version of the fused RbA kernel against rba_tpu's Pallas kernel (interpret
mode) and its jnp reference, at fp32 on the CPU (rtol 1e-4, atol 1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.ops.pallas.fused_rba import fused_rba_score as j_fused, fused_rba_score_reference as j_ref
from rba_tpu_torch.kernels import fused_rba as tfr
from tests.torch_port_common import record, t

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(rng, b, q, k, h, w):
    mask_cls = rng.randn(b, q, k + 1).astype(np.float32)
    mask_pred = (rng.randn(b, q, h, w) * 2).astype(np.float32)
    return mask_cls, mask_pred


# K = 7 (tiny config), K = 19 (Cityscapes), K = 40 (more than one 32-class chunk);
# h = 13 and w = 10 are not multiples of the Pallas kernel's 8-row tile
@pytest.mark.parametrize("bqk", [(1, 10, 7), (2, 100, 19), (1, 12, 40)], ids=["K7", "K19", "K40"])
@pytest.mark.parametrize("hw", [(8, 16), (13, 10)])
@pytest.mark.parametrize("layout", ["bqhw", "bhwq"])
def test_plain_matches_pallas(rng, bqk, hw, layout):
    b, q, k = bqk
    mask_cls, mask_pred = _inputs(rng, b, q, k, *hw)
    want = np.asarray(j_fused(jnp.asarray(mask_cls), jnp.asarray(mask_pred), interpret=True))
    want_ref = np.asarray(j_ref(jnp.asarray(mask_cls), jnp.asarray(mask_pred)))
    m = mask_pred if layout == "bqhw" else mask_pred.transpose(0, 2, 3, 1)
    got = tfr.fused_rba_score(t(mask_cls), t(m), masks_layout=layout).numpy()
    assert got.shape == (b, 4 * hw[0], 4 * hw[1])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


def test_rejects_unknown_layout(rng):
    mask_cls, mask_pred = _inputs(rng, 1, 4, 3, 2, 2)
    with pytest.raises(ValueError):
        tfr.fused_rba_score(t(mask_cls), t(mask_pred), masks_layout="qbhw")


def test_wrapper_rejects_other_devices(rng):
    mask_cls, mask_pred = _inputs(rng, 1, 4, 3, 2, 2)
    with pytest.raises(ValueError):
        tfr.fused_rba_score(t(mask_cls).to("meta"), t(mask_pred).to("meta"))


LOG2E = np.float32(1.4426950408889634)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna does: nearest with ties away from zero, the low 13
    mantissa bits clear."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _kernel_arithmetic(mask_cls: torch.Tensor, mask_pred: torch.Tensor, products: str = "split") -> torch.Tensor:
    """csrc/fused_rba.cu's arithmetic in plain torch, fp32: 4x4 patches that blend four
    edge-clamped low-res pixels (horizontal blend first, weights 1/8 .. 7/8), the sigmoid
    and tanh through 2^x and a reciprocal, and the class contraction as TF32 products
    summed in fp32: three of the split operands ("split") or one ("single")."""
    b, q, h, w = mask_pred.shape
    p = torch.nn.functional.pad(mask_pred, (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)  # (B, h+2, w+2, Q)
    l00, l01, l10, l11 = p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]  # patches (k, j): (B, h+1, w+1, Q)
    wgt = torch.tensor([0.125, 0.375, 0.625, 0.875])
    wx, wy = wgt.view(1, 1, 1, 1, 4, 1), wgt.view(1, 1, 4, 1, 1, 1)
    top = l00[:, :, None, :, None] + wx * (l01 - l00)[:, :, None, :, None]  # (B, h+1, 1, w+1, 4, Q)
    bot = l10[:, :, None, :, None] + wx * (l11 - l10)[:, :, None, :, None]
    v = (top + wy * (bot - top)).reshape(b, 4 * (h + 1), 4 * (w + 1), q)[:, 2:2 + 4 * h, 2:2 + 4 * w]
    s = 1.0 / (1.0 + torch.exp2(-LOG2E * v))
    cls = torch.softmax(mask_cls, dim=-1)[..., :-1]  # (B, Q, K)
    s_hi, c_hi = _tf32(s), _tf32(cls)
    sem = torch.einsum("byxq,bqk->byxk", s_hi, c_hi)
    if products == "split":
        s_lo, c_lo = _tf32(s - s_hi), _tf32(cls - c_hi)
        sem = torch.einsum("byxq,bqk->byxk", s_lo, c_hi) + torch.einsum("byxq,bqk->byxk", s_hi, c_lo) + sem
    return -(1.0 - 2.0 / (1.0 + torch.exp2(2.0 * LOG2E * sem))).sum(dim=-1)


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-20, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 0.1])
    got = _tf32(x)
    assert got[:4].tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]  # ties away from zero
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all() and abs(float(got[4]) - 0.1) <= 0.1 * 2.0**-11


# Q = 37 is padded to 40 in the kernel; 1 x 1 and 2 x 3 masks touch the clamped edge everywhere
@pytest.mark.parametrize("bqk", [(2, 100, 19), (1, 37, 7), (1, 12, 40)], ids=["Q100_K19_B2", "Q37_K7", "Q12_K40"])
@pytest.mark.parametrize("hw", [(8, 16), (13, 10), (1, 1), (2, 3)])
def test_kernel_arithmetic_matches_pallas(rng, request, bqk, hw):
    b, q, k = bqk
    mask_cls, mask_pred = _inputs(rng, b, q, k, *hw)
    got = _kernel_arithmetic(t(mask_cls), t(mask_pred)).numpy()
    want_ref = tfr.fused_rba_score_reference(t(mask_cls), t(mask_pred)).numpy()
    assert got.shape == (b, 4 * hw[0], 4 * hw[1])
    record(request, max_abs_vs_plain=np.abs(got - want_ref).max())
    np.testing.assert_allclose(got, want_ref, **TOL)
    want_jnp = np.asarray(j_ref(jnp.asarray(mask_cls), jnp.asarray(mask_pred)))  # rba_tpu's reference, any size
    record(request, max_abs_vs_rba_tpu_reference=np.abs(got - want_jnp).max())
    np.testing.assert_allclose(got, want_jnp, **TOL)
    if hw[0] >= 8:  # the Pallas kernel's blocks are 8 low-res rows
        want = np.asarray(j_fused(jnp.asarray(mask_cls), jnp.asarray(mask_pred), interpret=True))
        record(request, max_abs_vs_pallas=np.abs(got - want).max())
        np.testing.assert_allclose(got, want, **TOL)


def test_single_tf32_pass_is_worse(rng, request):
    """Why the kernel splits its operands: with one TF32 product the score's error
    against the plain version is an order of magnitude above the split form's."""
    mask_cls, mask_pred = _inputs(rng, 1, 100, 19, 16, 32)
    want = tfr.fused_rba_score_reference(t(mask_cls), t(mask_pred)).numpy()
    split = np.abs(_kernel_arithmetic(t(mask_cls), t(mask_pred)).numpy() - want).max()
    single = np.abs(_kernel_arithmetic(t(mask_cls), t(mask_pred), products="single").numpy() - want).max()
    record(request, split_max_abs=split, single_max_abs=single)
    assert split <= 1e-5 and single >= 10 * split


@pytest.mark.parametrize("q_k, takes", [((100, 19), True), ((200, 40), True), ((2000, 19), False)])
def test_shared_memory_rule(q_k, takes):
    """The wrapper refuses, by this rule on the shape alone, what does not fit a block."""
    assert (tfr.smem_bytes(*q_k) <= tfr.SMEM_LIMIT) == takes
