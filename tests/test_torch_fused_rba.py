"""The plain version of the fused RbA kernel against rba_tpu's Pallas kernel (interpret
mode) and its jnp reference, at fp32 on the CPU (rtol 1e-4, atol 1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.ops.pallas.fused_rba import fused_rba_score as j_fused, fused_rba_score_reference as j_ref
from rba_tpu_torch.kernels import fused_rba as tfr
from tests.torch_port_common import t

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
