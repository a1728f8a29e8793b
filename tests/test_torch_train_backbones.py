"""Training the non-Swin backbone families: the port against rba_tpu on the CPU at fp32.

Each family's full backbone (MiT at its smallest preset, B0) under ``tiny_test_config``'s
narrow head with one decoder layer and the coco-mix recipes' outlier loss, both packages
converted from one seeded Detectron2 dict, one 2 x 64 x 96 batch, the criterion's draws of
one key replayed into the port (``tests/torch_port_common.py`` ``TrainStepPair``):

- ResNet-50 at the R50 recipe's three deformable levels (res3–res5, the sampling's gather
  backward at three levels): each weighted loss within 1e-4 and every gradient, the
  batch norms' ``mean`` and ``var`` included (they are parameters, as in rba_tpu's tree;
  ROADMAP.md §C.11), within 1e-4 relative to its leaf's largest magnitude.  MiT-B0, ViT,
  ViT + SFP, MViT and WiderResNet-38: the ``_mit``, ``_vit``, ``_vit_sfp``, ``_mvit`` and
  ``_wrn`` files beside this one, one file per family to keep each under a minute of jax
  compiles.
- ``ms_deform_attn_core``'s gradient at three levels against rba_tpu's, and its backward
  inside the ``deform_sampling_backward`` span.
- (The optimizer's (multiplier, decay) partition of every family against rba_tpu's:
  ``tests/test_torch_train_backbones_optimizer.py``.)
- One full update of the frozen coco-mix recipe on the ResNet head through
  ``make_train_state`` / ``make_train_step``: every parameter within 1e-6 of rba_tpu's
  optax update of its own gradients, the frozen backbone and pixel decoder unchanged bit
  for bit, and ``grad_norm`` counting their gradients, as ``optax.global_norm`` does.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rba_tpu.ops import deform_sampling as jds
from rba_tpu.train import optimizer as jopt
from rba_tpu_torch.convert.params import jax_params_to_state, load_jax_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.ops import deform_sampling as tds
from rba_tpu_torch.train import train_step as tts
from tests.torch_port_common import (TRAIN_B, TRAIN_T, TrainStepPair, assert_gradients_match, assert_losses_match,
                                     criterion_draws, record, replay, t)

UPDATE_TOL = 1e-6  # parameters after one update


@pytest.fixture(scope="module")
def resnet():
    return TrainStepPair("resnet")


def test_losses_match_rba_tpu(resnet, request):
    record(request, loss_rel_err=assert_losses_match(resnet))


def test_gradients_match_rba_tpu(resnet, request):
    grads = assert_gradients_match(resnet, request)
    # the batch norms' statistics train by gradient, as in rba_tpu
    stats = [n for n in grads if n.startswith("backbone.") and n.endswith((".mean", ".var"))]
    assert len(stats) == 2 * (1 + 3 * 16 + 4) and all(np.abs(grads[n]).max() > 0 for n in stats)
    # the three deformable levels' sampling parameters take their gradient through the gather
    assert grads["sem_seg_head.pixel_decoder.transformer.level_embed"].shape[0] == 3


SHAPES = [(8, 12), (4, 6), (2, 3)]  # res3–res5 of a 64 x 96 frame


def _sampling_inputs(seed):
    rs = np.random.RandomState(seed)
    s, n, m, d, p = sum(h * w for h, w in SHAPES), 2, 2, 4, 4
    value = rs.randn(n, s, m, d).astype(np.float32)
    loc = rs.uniform(-0.1, 1.1, (n, s, m, len(SHAPES), p, 2)).astype(np.float32)  # every token a query
    attn = rs.rand(n, s, m, len(SHAPES), p).astype(np.float32)
    cot = rs.randn(n, s, m * d).astype(np.float32)
    return value, loc, attn, cot


def test_sampling_gradient_at_three_levels_matches_rba_tpu():
    value, loc, attn, cot = _sampling_inputs(3)

    def jloss(v, l, a):
        return jnp.sum(jds.ms_deform_attn_core(v, SHAPES, l, a, method="gather") * cot)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (value, loc, attn)))
    tv, tl, ta = (t(x).requires_grad_() for x in (value, loc, attn))
    (tds.ms_deform_attn_core(tv, SHAPES, tl, ta, method="gather") * t(cot)).sum().backward()
    for g, w in zip((tv.grad, tl.grad, ta.grad), want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_sampling_backward_runs_in_its_span():
    """Under autograd the sampling's backward opens ``BACKWARD_SPAN`` at the output's
    gradient and closes it at the inputs', once per call; without gradients no span."""
    from torch.profiler import ProfilerActivity, profile

    value, loc, attn, cot = _sampling_inputs(4)
    tv, tl, ta = (t(x).requires_grad_() for x in (value, loc, attn))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tds.ms_deform_attn_core(tv * 1, SHAPES, tl * 1, ta * 1)
        (out * t(cot)).sum().backward()
        with torch.no_grad():
            tds.ms_deform_attn_core(tv, SHAPES, tl, ta)
    spans = [e for e in prof.events() if e.name == tds.BACKWARD_SPAN]
    assert len(spans) == 1 and sum(e.name == tds.SPAN for e in prof.events()) == 2
    inside = [e.name for e in prof.events() if e.name.startswith("autograd::engine::evaluate_function")
              and spans[0].time_range.start <= e.time_range.start < spans[0].time_range.end]
    assert any("GatherBackward" in n for n in inside) and inside[-1].endswith("_CloseBackwardSpanBackward")


def test_frozen_update_equals_rba_tpu(resnet, monkeypatch):
    """The frozen coco-mix recipe's solver on the ResNet head: one step of the port's
    ``make_train_step`` against rba_tpu's optax chain applied to rba_tpu's gradients (the
    update of its ``step_fn``)."""
    solver = dict(freeze_backbone=True, freeze_pixel_decoder=True)
    jcfg, tcfg = (dataclasses.replace(c, solver=dataclasses.replace(c.solver, **solver))
                  for c in (resnet.jcfg, resnet.tcfg))
    tx = jopt.build_optimizer(jcfg, resnet.params)

    @jax.jit
    def update(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    want = jax_params_to_state(jax.tree_util.tree_map(np.asarray, update(resnet.want_tree, resnet.params)))
    want_norm = float(optax.global_norm(resnet.want_tree))
    head_norm = math.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for n, g in resnet.want_grads.items()
                              if n.startswith("sem_seg_head.predictor.")))

    model = tmf.build_model(tcfg, device="cpu")
    load_jax_params(model, resnet.params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = tts.make_train_state(tcfg, device="cpu", model=model)
    draws = criterion_draws(resnet.key, tcfg.loss, TRAIN_B, TRAIN_T, 1 + tcfg.decoder.dec_layers)
    monkeypatch.setattr(tts, "uniform_from", lambda gen, *a: replay(draws))
    metrics = tts.make_train_step(tcfg)(state, resnet.batch)

    assert abs(float(metrics["total"]) - resnet.want["total"]) <= 1e-4 * resnet.want["total"]
    assert abs(float(metrics["grad_norm"]) - want_norm) <= 1e-4 * want_norm
    assert want_norm > 1.1 * head_norm  # the frozen leaves' gradients count in the norm and the clip
    moved = 0
    for n, p in model.named_parameters():
        assert np.abs(p.detach().numpy() - want[n]).max() <= UPDATE_TOL, n
        if n.startswith(("backbone.", "sem_seg_head.pixel_decoder.")):
            assert torch.equal(p.detach(), before[n]), n  # frozen: bit for bit
        else:
            moved += int(not torch.equal(p.detach(), before[n]))
    assert moved == sum(1 for n in before if n.startswith("sem_seg_head.predictor."))
