"""The port's panoptic, open-panoptic and instance heads (``rba_tpu_torch/models/inference.py``)
against rba_tpu's on the same logits, on the CPU: the panoptic id map and its segments
equal, the open branch's plain RbA map within 1e-5, the instances equal (scores within
1e-6 relative: the mask scores are fp32 sums in another order), ties included."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from rba_tpu import config as jconfig
from rba_tpu.models import inference as jinf
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import inference as tinf
from tests.torch_port_common import max_abs, t

Q, K, H, W = 12, 19, 48, 64
RBA_TOL = 1e-5
SCORE_RTOL = 1e-6


def _logits(seed: int, unknown_block: bool = True):
    """Class logits with 8 confident queries (things, stuff, two of one stuff class and
    one of no object), each of which owns one 24x16 tile of the 48x64 frame, and noisy
    mask logits; with ``unknown_block`` every mask is far below zero on the no-object
    query's tile, which the open branch turns into an unknown segment."""
    rs = np.random.RandomState(seed)
    mask_cls = (rs.randn(Q, K + 1) * 0.5).astype(np.float32)
    mask_pred = np.full((Q, H, W), -4.0, np.float32) + rs.randn(Q, H, W).astype(np.float32) * 0.5
    for q, c in enumerate((13, 0, 0, 11, 2, 8, 19, 14)):  # 19: the no-object class
        mask_cls[q, c] += 6.0 + rs.rand()
        r, col = divmod(q, 4)
        mask_pred[q, 24 * r : 24 * (r + 1), 16 * col : 16 * (col + 1)] += 8.0
    if unknown_block:
        mask_pred[:, 24:48, 32:48] = -12.0  # the tile of query 6
    return mask_cls, mask_pred


@pytest.fixture(scope="module")
def cfgs():
    return jconfig.RbAConfig(), tconfig.RbAConfig()


def _assert_panoptic_equal(got, want):
    pan_g, seg_g = got
    pan_w, seg_w = want
    assert pan_g.dtype == np.int32 and pan_g.shape == np.asarray(pan_w).shape
    assert np.array_equal(pan_g, np.asarray(pan_w))
    assert seg_g == seg_w


@pytest.mark.parametrize("seed", [0, 1])
def test_panoptic_inference_closed_equals_rba_tpu(cfgs, seed):
    jcfg, tcfg = cfgs
    mask_cls, mask_pred = _logits(seed, unknown_block=False)
    want = jinf.panoptic_inference(jcfg, mask_cls, mask_pred)
    got = tinf.panoptic_inference(tcfg, t(mask_cls), t(mask_pred))
    _assert_panoptic_equal(got, want)
    assert len(got[1]) >= 3 and any(s["isthing"] for s in got[1]) and any(not s["isthing"] for s in got[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_panoptic_inference_open_equals_rba_tpu(cfgs, seed):
    """The open branch (rba_map computed from the logits): the map and the segments,
    with at least one unknown segment of category 255."""
    jcfg, tcfg = cfgs
    mask_cls, mask_pred = _logits(seed)
    want = jinf.panoptic_inference(jcfg, mask_cls, mask_pred, open_panoptic=True)
    got = tinf.panoptic_inference(tcfg, mask_cls, mask_pred, open_panoptic=True)
    _assert_panoptic_equal(got, want)
    assert any(s["category_id"] == 255 for s in got[1])


def test_open_rba_map_matches_rba_tpu():
    """The open branch's plain map, −Σ_k tanh(Σ_q softmax(cls)[q, k] · sigmoid(mask)[q]),
    as rba_tpu computes it inside panoptic_inference."""
    import jax

    mask_cls, mask_pred = _logits(0)
    probs = jax.nn.softmax(jnp.asarray(mask_cls), axis=-1)[:, :-1]
    want = -jnp.tanh(jnp.einsum("qc,qhw->chw", probs, jax.nn.sigmoid(jnp.asarray(mask_pred)))).sum(0)
    assert max_abs(tinf.open_rba_map(t(mask_cls), t(mask_pred)), want) <= RBA_TOL


def test_panoptic_inference_nothing_kept(cfgs):
    jcfg, tcfg = cfgs
    mask_cls, mask_pred = _logits(0)
    mask_cls[:, -1] += 50.0  # every query predicts no object
    _assert_panoptic_equal(tinf.panoptic_inference(tcfg, mask_cls, mask_pred, open_panoptic=True),
                           jinf.panoptic_inference(jcfg, mask_cls, mask_pred, open_panoptic=True))


def _assert_instances_equal(got, want):
    want = {k: np.asarray(v) for k, v in want.items()}
    assert np.array_equal(got["pred_classes"], want["pred_classes"])
    assert got["pred_masks"].dtype == bool
    assert np.array_equal(got["pred_masks"], want["pred_masks"] > 0)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("panoptic_on", [False, True])
def test_instance_inference_equals_rba_tpu(panoptic_on):
    jcfg = dataclasses.replace(jconfig.RbAConfig(), test=dataclasses.replace(jconfig.TestConfig(), panoptic_on=panoptic_on))
    tcfg = dataclasses.replace(tconfig.RbAConfig(), test=dataclasses.replace(tconfig.TestConfig(), panoptic_on=panoptic_on))
    mask_cls, mask_pred = _logits(0)
    want = jinf.instance_inference(jcfg, mask_cls, mask_pred, topk=40)
    got = tinf.instance_inference(tcfg, t(mask_cls), t(mask_pred), topk=40)
    _assert_instances_equal(got, want)
    assert len(got["scores"]) == (len(want["scores"]) if panoptic_on else 40)


def test_instance_inference_ties_take_the_lower_index_first():
    """Two queries with the same class logits and a query with two equal classes: the
    top-k keeps jax.lax.top_k's order (the lower flat index first), and a budget above
    Q·K takes every pair."""
    jcfg, tcfg = jconfig.RbAConfig(), tconfig.RbAConfig()
    mask_cls, mask_pred = _logits(1)
    mask_cls[5] = mask_cls[2]  # queries 2 and 5 tie on every class
    mask_cls[7, 3] = mask_cls[7, 4] = 9.0  # query 7 ties on two classes
    for topk in (7, Q * K + 5):
        want = jinf.instance_inference(jcfg, mask_cls, mask_pred, topk=topk)
        got = tinf.instance_inference(tcfg, mask_cls, mask_pred, topk=topk)
        _assert_instances_equal(got, want)
    assert len(got["scores"]) == Q * K
