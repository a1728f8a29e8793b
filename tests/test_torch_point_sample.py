"""``ops/point_sample.py`` against ``rba_tpu/ops/point_sample.py`` on the CPU: one
``grid_sample`` against rba_tpu's four lowerings (the matcher's Q >= 64 patch gather,
the criterion's Q = 1 one-hot matmul and lane gather, the corner gather), within 1e-6;
``uncertain_point_coords`` with rba_tpu's draws replayed, the same points chosen; the
top-k tie order of ``jax.lax.top_k``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.ops import point_sample as jps
from rba_tpu_torch.ops import point_sample as tps
from tests.torch_port_common import max_abs, replay, t

TOL = 1e-6  # fp32 bilinear weights computed in another order


def _coords(rs, b, p):
    c = rs.rand(b, p, 2).astype(np.float32)
    c[:, :4] = [[0.0, 0.0], [1.0, 1.0], [0.999, 0.001], [0.5, 1.0]]  # the zero padding at the edges
    return c


@pytest.mark.parametrize("shape", [(2, 64, 12, 20), (2, 100, 16, 32), (6, 1, 16, 24), (3, 1, 260, 260),
                                   (2, 5, 9, 11)],
                         ids=["matcher_q64", "matcher_q100", "criterion_q1_small", "criterion_q1_large", "corners"])
def test_point_sample_matches_rba_tpu(shape):
    rs = np.random.RandomState(sum(shape))
    masks = rs.randn(*shape).astype(np.float32)
    coords = _coords(rs, shape[0], 37)
    want = jps.point_sample(jnp.asarray(masks), jnp.asarray(coords))
    got = tps.point_sample(t(masks), t(coords))
    assert got.shape == want.shape == (shape[0], shape[1], 37)
    assert max_abs(got, want) <= TOL


def test_uncertain_point_coords_with_replayed_draws():
    rs = np.random.RandomState(3)
    logits = rs.randn(5, 1, 14, 18).astype(np.float32)
    key = jax.random.PRNGKey(7)
    num_points, over, imp = 40, 3.0, 0.75
    want = jps.uncertain_point_coords(key, jnp.asarray(logits), num_points, over, imp)
    k1, k2 = jax.random.split(key)
    uniform = replay([jax.random.uniform(k1, (5, 120, 2)), jax.random.uniform(k2, (5, 10, 2))])
    got = tps.uncertain_point_coords(uniform, t(logits), num_points, over, imp)
    assert not uniform.left
    # the same points chosen from the same draws, in the same order
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_top_k_ties_follow_jax():
    x = np.array([[1, 3, 3, 0, 3, 2, 2], [5, 5, 5, 5, 1, 1, 0]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), 5)
    assert np.array_equal(tps.top_k_indices(t(x), 5).numpy(), np.asarray(want))


def test_uniform_from_generator():
    gen = torch.Generator().manual_seed(0)
    u = tps.uniform_from(gen)((3, 4, 2))
    assert u.shape == (3, 4, 2) and u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
