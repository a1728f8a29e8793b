"""``train/matcher.py`` against ``rba_tpu/train/matcher.py`` on the CPU, with rba_tpu's
uniform points replayed into the port: the matching cost within 1e-6 relative (of
max(1, |cost|)) and the assignment equal (int equality); ``fixed_match`` equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rba_tpu.config import LossConfig as JLoss
from rba_tpu.ops.point_sample import point_sample as jpoint_sample
from rba_tpu.train import matcher as jm
from rba_tpu_torch.config import LossConfig as TLoss
from rba_tpu_torch.train import matcher as tm
from tests.torch_port_common import replay, t

COST_TOL = 1e-6  # relative: fp32 sums of ~10 in another order differ by a few ulps


def _inputs(seed, b=3, q=10, k=7, t_=5, h=12, w=16):
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, q, k + 1).astype(np.float32)
    masks = (rs.randn(b, q, h, w) * 2).astype(np.float32)
    labels = rs.randint(0, k, (b, t_)).astype(np.int32)
    gt = (rs.rand(b, t_, 4 * h, 4 * w) < 0.3).astype(np.float32)
    valid = np.ones((b, t_), np.float32)
    valid[1, 3:] = 0  # padded targets
    valid[2, 1:] = 0
    return logits, masks, labels, gt, valid


def _jax_cost(cfg, coords, logits, masks, labels, gt, valid):
    """rba_tpu's matching cost, the lines of hungarian_match before the LSAP."""
    out_prob = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    cost_class = -jnp.take_along_axis(out_prob, jnp.asarray(labels)[:, None, :], axis=2)
    out_points = jpoint_sample(jnp.asarray(masks), coords)
    tgt_points = jpoint_sample(jnp.asarray(gt), coords)
    cost = (cfg.mask_weight * jm._batch_sigmoid_ce_cost(out_points, tgt_points) + cfg.class_weight * cost_class
            + cfg.dice_weight * jm._batch_dice_cost(out_points, tgt_points))
    cost = jnp.transpose(cost, (0, 2, 1))
    return jnp.where(jnp.asarray(valid)[:, :, None] > 0, cost, jm.INVALID_COST)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_match_equals_rba_tpu(seed):
    jcfg, tcfg = JLoss(train_num_points=96), TLoss(train_num_points=96)
    args = _inputs(seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jm.hungarian_match(key, jcfg, *map(jnp.asarray, args)))
    coords = jax.random.uniform(key, (3, 96, 2))  # hungarian_match's one draw
    got = tm.hungarian_match(replay([coords]), tcfg, *map(t, args[:2]), *map(_long, args[2:3]), *map(t, args[3:]))
    assert np.array_equal(got.numpy(), want)
    cost = tm.match_cost(replay([coords]), tcfg, *map(t, args[:2]), _long(args[2]), *map(t, args[3:]))
    want_cost = np.asarray(_jax_cost(jcfg, coords, *args))
    assert np.all(np.abs(cost.numpy() - want_cost) <= COST_TOL * np.maximum(1.0, np.abs(want_cost)))


def test_more_targets_than_queries_raises():
    logits, masks, labels, gt, valid = _inputs(0, q=4)
    with pytest.raises(ValueError, match="num_queries"):
        tm.match_cost(replay([]), TLoss(), t(logits), t(masks), _long(labels), t(gt), t(valid))


def test_fixed_match_equals_rba_tpu():
    labels = np.array([[0, 3, 9, 12], [5, 5, 1, 0]], np.int32)
    assert np.array_equal(tm.fixed_match(_long(labels), 10).numpy(), np.asarray(jm.fixed_match(jnp.asarray(labels), 10)))


def _long(a):
    import torch

    return torch.from_numpy(np.asarray(a, np.int64))
