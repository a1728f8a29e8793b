"""The training step of the port against rba_tpu's on the CPU at the tiny config (fp32),
the weights carried across with ``load_jax_params`` and rba_tpu's ``jax.random`` draws
replayed into the port:

- the decoder's ``aux_outputs`` against rba_tpu's ``need_aux=True``, within 1e-4;
- one step's loss and every parameter's gradient against ``jax.value_and_grad`` of
  rba_tpu's ``loss_fn`` body (``preprocess``, ``maskformer_forward``, ``criterion``),
  within 1e-4 relative to each leaf's largest magnitude;
- (the optimizer: tests/test_torch_optimizer.py);
- ``grad_accum=2`` equal to one step over the whole batch (within 1e-5);
- a per-pixel head's step (tests/test_torch_train_heads.py holds the other heads' gradients)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu.train import criterion as jcrit
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert.params import jax_params_to_state, load_jax_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.train import criterion as tcrit
from rba_tpu_torch.train import train_step as tts
from tests.torch_port_common import criterion_draws, d2_model_pair, replay, t

FWD_TOL = 1e-4  # aux outputs: fp32 through Swin, the pixel decoder and the decoder
GRAD_TOL = 1e-4  # relative to each leaf's largest gradient
B, HW, T, POINTS = 2, (32, 32), 3, 48
OOD = dict(outlier_supervision=True, outlier_loss_target="nls", score_norm="tanh", outlier_loss_func="squared_hinge")


def _cfgs(**solver):
    out = []
    for pkg in (jconfig, tconfig):
        c = pkg.tiny_test_config()
        out.append(dataclasses.replace(c, ood=dataclasses.replace(c.ood, **OOD),
                                       loss=dataclasses.replace(c.loss, train_num_points=POINTS),
                                       solver=dataclasses.replace(c.solver, **solver)))
    return out


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    params, model = d2_model_pair(jcfg, tcfg, seed=3)
    return jcfg, tcfg, params, model


def _batch(seed, b=B):
    rs = np.random.RandomState(seed)
    h, w = HW
    sem = rs.randint(0, 4, (b, h, w)).astype(np.int32)
    sem[:, 12:20, 8:14] = 254
    batch = dict(images=(rs.rand(b, h, w, 3) * 255).astype(np.float32),
                 gt_labels=np.tile(np.arange(T, dtype=np.int32), (b, 1)),
                 gt_masks=np.stack([[sem[i] == c for c in range(T)] for i in range(b)]).astype(np.float32),
                 gt_valid=np.ones((b, T), np.float32), sem_seg=sem,
                 outlier_masks=(sem == 254).astype(np.int32))
    batch["gt_valid"][-1, -1] = 0.0
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in batch.items()}


def test_aux_outputs_match_rba_tpu(pair):
    jcfg, tcfg, params, model = pair
    img = _batch(0)["images"]
    want = jax.jit(lambda p, x: jmf.maskformer_forward(p, jcfg, jmf.preprocess(jcfg, x), need_aux=True))(
        params, jnp.asarray(img))
    with torch.no_grad():
        got = tmf.maskformer_forward(model, tcfg, tmf.preprocess(tcfg, t(img)), need_aux=True, attention="xla")
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == tcfg.decoder.dec_layers
    for g, w in zip([got] + got["aux_outputs"], [want] + want["aux_outputs"]):
        for k in ("pred_logits", "pred_masks"):
            assert g[k].shape == w[k].shape
            assert np.abs(g[k].numpy() - np.asarray(w[k])).max() <= FWD_TOL, k


def test_loss_and_gradients_match_rba_tpu(pair):
    jcfg, tcfg, params, model = pair
    batch = _batch(1)
    key = jax.random.PRNGKey(5)

    def loss_fn(p, b):  # the body of rba_tpu's make_train_step loss_fn
        outputs = jmf.maskformer_forward(p, jcfg, jmf.preprocess(jcfg, b["images"]))
        losses = jcrit.criterion(jcfg, key, outputs, {k: v for k, v in b.items() if k != "images"})
        return losses["total"], losses

    (want_total, _), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    uniform = replay(criterion_draws(key, jcfg.loss, B, T, 1 + tcfg.decoder.dec_layers))
    tb = _tbatch(batch)
    model.zero_grad(set_to_none=True)
    outputs = tmf.maskformer_forward(model, tcfg, tmf.preprocess(tcfg, tb["images"]), need_aux=True, attention="xla")
    losses = tcrit.criterion(tcfg, uniform, outputs, {k: v for k, v in tb.items() if k != "images"})
    assert not uniform.left
    losses["total"].backward()
    assert abs(float(losses["total"].detach()) - float(want_total)) <= GRAD_TOL * abs(float(want_total))
    want = jax_params_to_state(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in model.named_parameters():
        w = want[name]
        assert p.grad is not None, name
        assert np.abs(p.grad.numpy() - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-12), name
    model.zero_grad(set_to_none=True)


def test_grad_accum_equals_one_full_batch_step(pair, monkeypatch):
    """A batch of two copies of one sample: two micro-batches (each drawing the same
    points) and the whole batch (drawing each point twice) give the same losses and the
    same update."""
    _, tcfg, params, _ = pair
    one = _batch(4, b=1)
    batch = {k: np.concatenate([v, v]) for k, v in one.items()}
    key = jax.random.PRNGKey(9)
    draws = [np.asarray(d) for d in criterion_draws(key, tcfg.loss, 1, T, 1 + tcfg.decoder.dec_layers)]
    results = []
    for accum, seq in ((2, draws + draws), (1, [np.concatenate([d, d]) for d in draws])):
        model = tmf.build_model(tcfg, device="cpu")
        load_jax_params(model, params)
        state = tts.make_train_state(tcfg, device="cpu", model=model)
        monkeypatch.setattr(tts, "uniform_from", lambda gen, *a, seq=seq: replay(seq))
        metrics = tts.make_train_step(tcfg, grad_accum=accum)(state, batch)
        results.append((metrics, dict(model.named_parameters())))
    (m2, p2), (m1, p1) = results
    assert sorted(m2) == sorted(m1)
    for k in m1:
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * max(1.0, abs(float(m1[k]))), k
    for name in p1:
        assert torch.allclose(p2[name], p1[name], rtol=0, atol=1e-6), name


def test_per_pixel_head_is_refused():
    """Refused until ROADMAP.md §A.6 ported it, the per-pixel head now trains: one step of
    ``make_train_step`` on the tiny config, its loss (the cross-entropy of the ×4 upsampled
    logits over sem_seg) within 1e-5 of rba_tpu's ``per_pixel_losses`` on the same logits
    (tests/test_torch_heads.py holds the logits against rba_tpu's), and every parameter
    updated."""
    from rba_tpu.models import baseline_heads as jbh
    from tests.torch_port_common import d2_model_pair, jax_config

    tcfg = dataclasses.replace(_cfgs()[1], sem_seg_head_name="PerPixelBaselineHead")
    jcfg = jax_config(tcfg)
    _, model = d2_model_pair(jcfg, tcfg, seed=3)
    batch = _batch(2)
    with torch.no_grad():
        logits, _ = tmf.per_pixel_forward(model, tcfg, tmf.preprocess(tcfg, t(batch["images"])), attention="xla")
    want = float(jbh.per_pixel_losses(jcfg, jax.random.PRNGKey(0), jnp.asarray(logits.numpy()), [],
                                      jnp.asarray(batch["sem_seg"]))["loss_sem_seg"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = tts.make_train_state(tcfg, model=model, seed=0)
    metrics = tts.make_train_step(tcfg)(state, batch)
    assert sorted(metrics) == ["grad_norm", "loss_sem_seg", "total"]
    assert abs(float(metrics["loss_sem_seg"]) - want) <= 1e-5 * max(1.0, abs(want))
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())
