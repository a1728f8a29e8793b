"""The plain LSAP (``rba_tpu_torch/ops/lsap.py``, the matcher's CPU path and Kernel E's reference)
against ``rba_tpu.ops.lsap.batched_linear_sum_assignment``: the same assignment exactly
(int equality), and its total cost equal to scipy's optimum, on random fp32 costs,
integer costs (ties), padded rows at 1e6, R = C and R < C.  Kernel E itself is held
against this on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from rba_tpu.ops.lsap import batched_linear_sum_assignment as jax_lsa
from rba_tpu_torch.kernels import lsap as klsap
from rba_tpu_torch.ops.lsap import batched_linear_sum_assignment
from rba_tpu_torch.train import matcher as tm


def _costs(kind, shape, seed):
    rs = np.random.RandomState(seed)
    if kind == "int":
        c = rs.randint(0, 4, shape).astype(np.float32)
    else:
        c = rs.rand(*shape).astype(np.float32) * 10 - 3
    if kind == "padded":
        c[:, -3:, :] = 1e6  # the matcher's padded targets
    return c


@pytest.mark.parametrize("kind", ["rand", "int", "padded"])
@pytest.mark.parametrize("shape", [(3, 12, 12), (4, 8, 20)], ids=["R=C", "R<C"])
def test_plain_lsap_equals_rba_tpu_and_scipy(kind, shape):
    cost = _costs(kind, shape, seed=len(kind) + shape[2])
    got = batched_linear_sum_assignment(torch.from_numpy(cost))
    assert got.dtype == torch.int32 and got.shape == shape[:2]
    want = np.asarray(jax_lsa(jnp.asarray(cost)))
    assert np.array_equal(got.numpy(), want)
    for c, a in zip(cost, got.numpy()):
        assert len(set(a.tolist())) == len(a)  # a column per row, none twice
        r, col = scipy_lsa(c)
        assert c[np.arange(len(a)), a].astype(np.float64).sum() == c[r, col].astype(np.float64).sum()


def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    """On a CPU cost the matcher's route runs the plain version and launches nothing; the
    kernel's own wrapper raises there."""
    cost = torch.from_numpy(_costs("rand", (2, 6, 9), seed=5))
    monkeypatch.setattr(tm, "match_cost", lambda *args: cost)
    before = klsap.batched_linear_sum_assignment.launches
    got = tm.hungarian_match(None, None, None, None, None, None, None)
    assert klsap.batched_linear_sum_assignment.launches == before
    assert torch.equal(got, batched_linear_sum_assignment(cost))
    with pytest.raises(ValueError, match="cuda"):
        klsap.batched_linear_sum_assignment(cost)


@pytest.mark.parametrize("shape", [(1, 5, 4), (1, 10, 1025), (2, 3, 3, 3)])
def test_kernel_refuses_shapes_loudly(shape):
    with pytest.raises(ValueError):
        klsap._check(torch.zeros(shape))
