"""``train/criterion.py`` against ``rba_tpu/train/criterion.py`` on the CPU at the tiny
config's widths, with rba_tpu's ``jax.random`` draws replayed into the port: each of the
seven losses within 1e-5 relative, every ``outlier_loss_func`` and outlier-loss target
with and without outlier pixels, ``criterion`` with deep supervision, and its gradient
with respect to every layer's ``pred_logits`` / ``pred_masks`` within 1e-5 of the
largest."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.train import criterion as jc
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.train import criterion as tc
from tests.torch_port_common import criterion_draws, replay, t

REL = 1e-5  # fp32 reductions in another order
K, Q, T, B, H, W = 7, 10, 4, 2, 32, 40  # masks at stride 4: 8x10
POINTS = 48


def _cfgs(**ood):
    j, p = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    return (dataclasses.replace(j, ood=dataclasses.replace(j.ood, **ood),
                                loss=dataclasses.replace(j.loss, train_num_points=POINTS)),
            dataclasses.replace(p, ood=dataclasses.replace(p.ood, **ood),
                                loss=dataclasses.replace(p.loss, train_num_points=POINTS)))


def _preds(rs, layers=3):
    return [(rs.randn(B, Q, K + 1).astype(np.float32), (rs.randn(B, Q, H // 4, W // 4) * 3).astype(np.float32))
            for _ in range(layers)]


def _targets(rs, has_ood=True):
    sem = rs.randint(0, K, (B, H, W)).astype(np.int32)
    sem[:, :3] = 255
    if has_ood:
        sem[0, 10:16, 5:12] = 254
    out = np.where(sem == 254, 1, np.where(sem == 255, 255, 0)).astype(np.int32)
    labels = np.zeros((B, T), np.int32)
    masks = np.zeros((B, T, H, W), np.float32)
    valid = np.zeros((B, T), np.float32)
    for b in range(B):
        for i, c in enumerate(np.unique(sem[b][sem[b] < K])[: T - b]):
            labels[b, i], masks[b, i], valid[b, i] = c, sem[b] == c, 1.0
    return dict(gt_labels=labels, gt_masks=masks, gt_valid=valid, outlier_masks=out, sem_seg=sem)


def _close(got, want, rel=REL):
    got, want = float(got.detach() if isinstance(got, torch.Tensor) else got), float(want)
    assert abs(got - want) <= rel * max(1.0, abs(want)), (got, want)


def _tt(targets):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in targets.items()}


@pytest.mark.parametrize("target,norm", [("nls", "tanh"), ("nls", "sigmoid"), ("nls", "none"), ("energy", "none"),
                                         ("softmax_entropy", "none"), ("sum_entropy", "none")])
def test_ood_score_targets(target, norm):
    jcfg, tcfg = _cfgs(outlier_loss_target=target, score_norm=norm)
    rs = np.random.RandomState(1)
    (logits, masks), = _preds(rs, 1)
    tg = _targets(rs)
    want = jc.outlier_loss(jcfg, jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(tg["outlier_masks"]))
    _close(tc.outlier_loss(tcfg, t(logits), t(masks), torch.from_numpy(tg["outlier_masks"])), want)


@pytest.mark.parametrize("fn", ["max", "squared_hinge", "binary_cross_entropy", "mse", "l1"])
@pytest.mark.parametrize("has_ood", [True, False])
def test_outlier_loss_funcs(fn, has_ood):
    jcfg, tcfg = _cfgs(outlier_loss_target="nls", score_norm="tanh", outlier_loss_func=fn)
    rs = np.random.RandomState(2)
    (logits, masks), = _preds(rs, 1)
    om = _targets(rs, has_ood)["outlier_masks"]
    assert (om == 1).any() == has_ood
    want = jc.outlier_loss(jcfg, jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(om))
    _close(tc.outlier_loss(tcfg, t(logits), t(masks), torch.from_numpy(om)), want)


@pytest.mark.parametrize("score", ["none", "energy", "softmax_entropy"])
def test_smoothness_and_sparsity(score):
    jcfg, tcfg = _cfgs(smoothness_score=score)
    rs = np.random.RandomState(3)
    (logits, masks), = _preds(rs, 1)
    om = _targets(rs)["outlier_masks"]
    _close(tc.smoothness_loss(tcfg, t(logits), t(masks)), jc.smoothness_loss(jcfg, jnp.asarray(logits),
                                                                              jnp.asarray(masks)))
    _close(tc.sparsity_loss(tcfg, t(logits), t(masks), torch.from_numpy(om)),
           jc.sparsity_loss(jcfg, jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(om)))


@pytest.mark.parametrize("has_ood", [True, False])
def test_gambler_and_densehybrid(has_ood):
    jcfg, tcfg = _cfgs()
    rs = np.random.RandomState(4)
    (logits, masks), = _preds(rs, 1)
    tg = _targets(rs, has_ood)
    ood_pred = rs.randn(B, 2, H // 4, W // 4).astype(np.float32)
    om, sem = tg["outlier_masks"], tg["sem_seg"]
    wg, wd = jax.jit(lambda l, m, o, om_, s_: (jc.gambler_loss(jcfg, l, m, om_, s_),
                                                jc.densehybrid_loss(jcfg, l, m, o, om_, s_)))(
        *map(jnp.asarray, (logits, masks, ood_pred, om, sem)))
    _close(tc.gambler_loss(tcfg, t(logits), t(masks), torch.from_numpy(om), torch.from_numpy(sem)), wg)
    _close(tc.densehybrid_loss(tcfg, t(logits), t(masks), t(ood_pred), torch.from_numpy(om), torch.from_numpy(sem)),
           wd)


def test_gaussian_blur_matches():
    x = np.random.RandomState(5).randn(2, 9, 13).astype(np.float32)
    got = tc._gaussian_blur_2d(t(x)).numpy()
    assert np.abs(got - np.asarray(jc._gaussian_blur_2d(jnp.asarray(x)))).max() <= 1e-6


def test_labels_and_masks_losses():
    jcfg, tcfg = _cfgs()
    rs = np.random.RandomState(6)
    (logits, masks), = _preds(rs, 1)
    tg = _targets(rs)
    assignment = np.stack([rs.permutation(Q)[:T] for _ in range(B)]).astype(np.int32)
    want = jc.loss_labels(jcfg, jnp.asarray(logits), jnp.asarray(tg["gt_labels"]), jnp.asarray(tg["gt_valid"]),
                          jnp.asarray(assignment))
    tt = _tt(tg)
    _close(tc.loss_labels(tcfg, t(logits), tt["gt_labels"], tt["gt_valid"], torch.from_numpy(assignment)), want)
    key = jax.random.PRNGKey(3)
    num_masks = float(tg["gt_valid"].sum())
    wm, wd = jax.jit(lambda *a: jc.loss_masks(jcfg, key, *a, num_masks))(
        *map(jnp.asarray, (masks, tg["gt_masks"], tg["gt_valid"], assignment)))
    k1, k2 = jax.random.split(key)
    uniform = replay([jax.random.uniform(k1, (B * T, 3 * POINTS, 2)), jax.random.uniform(k2, (B * T, POINTS // 4, 2))])
    gm, gd = tc.loss_masks(tcfg, uniform, t(masks), tt["gt_masks"], tt["gt_valid"], torch.from_numpy(assignment),
                           torch.tensor(num_masks))
    _close(gm, wm)
    _close(gd, wd)


FULL = dict(outlier_supervision=True, outlier_loss_target="nls", score_norm="tanh", outlier_loss_func="squared_hinge",
            smoothness_loss=True, sparsity_loss=True, gambler_loss=True)


def _outputs(preds, conv):
    (l0, m0), *aux = preds
    return {"pred_logits": conv(l0), "pred_masks": conv(m0),
            "aux_outputs": [{"pred_logits": conv(l), "pred_masks": conv(m)} for l, m in aux]}


def _cfgs_with(matcher):
    jcfg, tcfg = _cfgs(**FULL)
    return (dataclasses.replace(jcfg, loss=dataclasses.replace(jcfg.loss, matcher=matcher)),
            dataclasses.replace(tcfg, loss=dataclasses.replace(tcfg.loss, matcher=matcher)))


@pytest.fixture(scope="module")
def hungarian():
    """rba_tpu's losses and their gradient with respect to every layer's predictions,
    from one jitted value_and_grad, with the Hungarian matcher and every loss on."""
    jcfg, tcfg = _cfgs_with("HungarianMatcher")
    rs = np.random.RandomState(7)
    preds, tg = _preds(rs), _targets(rs)
    key = jax.random.PRNGKey(11)
    jt = {k: jnp.asarray(v) for k, v in tg.items()}

    def total(flat):
        losses = jc.criterion(jcfg, key, _outputs([(flat[2 * i], flat[2 * i + 1]) for i in range(len(preds))],
                                                  lambda x: x), jt)
        return losses["total"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [jnp.asarray(a) for pair in preds for a in pair])
    return tcfg, preds, tg, key, losses, grads


def _port(tcfg, preds, tg, key, matcher=True):
    uniform = replay(criterion_draws(key, tcfg.loss, B, T, len(preds), matcher=matcher))
    tpreds = [(t(l).requires_grad_(), t(m).requires_grad_()) for l, m in preds]
    got = tc.criterion(tcfg, uniform, _outputs(tpreds, lambda x: x), _tt(tg))
    assert not uniform.left
    return got, tpreds


@pytest.mark.parametrize("matcher", ["HungarianMatcher", "FixedMatcher"])
def test_criterion_with_deep_supervision(matcher, hungarian):
    if matcher == "HungarianMatcher":
        tcfg, preds, tg, key, want, _ = hungarian
    else:
        jcfg, tcfg = _cfgs_with(matcher)
        rs = np.random.RandomState(7)
        preds, tg, key = _preds(rs), _targets(rs), jax.random.PRNGKey(11)
        want = jax.jit(lambda o, tgt: jc.criterion(jcfg, key, o, tgt))(
            _outputs(preds, jnp.asarray), {k: jnp.asarray(v) for k, v in tg.items()})
    got, _ = _port(tcfg, preds, tg, key, matcher=matcher == "HungarianMatcher")
    assert sorted(got) == sorted(want)  # the same losses (a jitted dict comes back in key order)
    assert "loss_ce_1" in got and "outlier_loss_1" in got and "gambler_loss" in got
    for k in want:
        _close(got[k], want[k])


def test_criterion_gradient(hungarian):
    """d total / d (pred_logits, pred_masks) of the final and both aux layers."""
    tcfg, preds, tg, key, _, want = hungarian
    got, tpreds = _port(tcfg, preds, tg, key)
    got["total"].backward()
    for (l, m), wl, wm in zip(tpreds, want[0::2], want[1::2]):
        for g, w in ((l.grad, wl), (m.grad, wm)):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= REL * np.abs(w).max()
