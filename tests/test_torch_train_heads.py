"""One training step of the other heads in the port against rba_tpu's on the CPU at the
tiny config (fp32), the weights converted in both packages from one seeded Detectron2
dict and rba_tpu's ``jax.random`` draws replayed into the port:

- MaskFormer v1 (``BasePixelDecoder`` + ``StandardTransformerDecoder``), each decoder
  layer supervised through the criterion and the Hungarian matcher;
- ``PerPixelBaselineHead`` with PointRend's sampled points (its dense cross-entropy:
  tests/test_torch_train_step.py);
- ``PerPixelBaselinePlusHead`` on the ``TransformerEncoderPixelDecoder`` in pre-norm, its
  decoder layers supervised.

Against ``jax.value_and_grad`` of rba_tpu's ``make_train_step`` loss body, each weighted
loss within 1e-4 (relative to max(1, |loss|)) and every gradient within 1e-4 of its
leaf's largest magnitude.  The seeded dict's weights (N(0, 0.02²)) leave the DETR
decoder's queries nearly alike, so its gradients are differences of near-equal terms
that fp32 does not resolve (up to 0.3 of a leaf's size); the predictor's weights are
scaled ×3, where its attention tells the queries apart.  Two leaves have no gradient in
exact arithmetic and are held as rounding noise, below 1e-6 of the model's largest
gradient on both sides:

- the first post-norm DETR decoder layer's self-attention projection weight: its input
  starts at zero, so every value is the value bias and the output is that bias whatever
  the softmax's weights (under pre-norm the input is the norm's bias, which gives the
  value rows a gradient);
- the Plus head's last mask-embedding bias, which adds one map to every class logit,
  which the softmax over the classes removes.

Also the optimizer's (multiplier, decay) partition of every leaf equal to rba_tpu's, and
a step of the port's ``make_train_step``: finite metrics, every parameter with a gradient
moved."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.convert.d2_mapping import convert_d2_state_dict as jconvert
from rba_tpu.models import baseline_heads as jbh
from rba_tpu.models import maskformer as jmf
from rba_tpu.train import criterion as jcrit
from rba_tpu.train import optimizer as jopt
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert.params import jax_params_to_state, jax_path, load_jax_params
from rba_tpu_torch.models import baseline_heads as tbh
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.train import criterion as tcrit
from rba_tpu_torch.train import optimizer as topt
from rba_tpu_torch.train import train_step as tts
from tests.d2_synthetic import d2_state_dict
from tests.torch_port_common import criterion_draws, record, replay, to_jax

LOSS_TOL = 1e-4  # each weighted loss, relative to max(1, |loss|)
GRAD_TOL = 1e-4  # each gradient, relative to its leaf's largest magnitude
NOISE = 1e-6  # a leaf without a gradient in exact arithmetic, relative to the largest gradient
PREDICTOR_SCALE = 3.0
ZERO = {"sem_seg_head.predictor.dec_layers.0.self_attn.in_proj.weight": ("v1",),
        "sem_seg_head.predictor.mask_embed.layers.2.bias": ("plus",)}
B, HW, T, POINTS = 2, (32, 32), 3, 48

HEADS = {
    "v1": dict(pixel_decoder=dict(name="BasePixelDecoder"),
               decoder=dict(name="StandardTransformerDecoder", transformer_in_feature="res3", dec_layers_total=2)),
    "per_pixel_point_rend": dict(sem_seg_head_name="PerPixelBaselineHead", pixel_decoder=dict(name="BasePixelDecoder"),
                                 loss=dict(use_point_rend=True)),
    "plus": dict(sem_seg_head_name="PerPixelBaselinePlusHead",
                 pixel_decoder=dict(name="TransformerEncoderPixelDecoder", transformer_enc_layers=1),
                 decoder=dict(name="StandardTransformerDecoder", transformer_in_feature="transformer_encoder",
                              num_queries=7, dec_layers_total=2, pre_norm=True)),
}


def head_cfg(pkg, name):
    """``tiny_test_config`` with the head ``name`` at fp32, one Swin block per stage, 48 points."""
    kw = dict(HEADS[name])
    c = pkg.tiny_test_config()
    parts = {k: dataclasses.replace(getattr(c, k), **kw.pop(k, {})) for k in ("pixel_decoder", "decoder", "loss")}
    parts["loss"] = dataclasses.replace(parts["loss"], train_num_points=POINTS)
    parts["swin"] = dataclasses.replace(c.swin, depths=(1, 1))
    return dataclasses.replace(c, **parts, **kw)


def _batch(seed):
    rs = np.random.RandomState(seed)
    h, w = HW
    sem = rs.randint(0, 5, (B, h, w)).astype(np.int32)
    sem[:, 12:20, 8:14] = 254
    sem[:, :3, :] = 255
    batch = dict(images=(rs.rand(B, h, w, 3) * 255).astype(np.float32),
                 gt_labels=np.tile(np.arange(T, dtype=np.int32), (B, 1)),
                 gt_masks=np.stack([[sem[i] == c for c in range(T)] for i in range(B)]).astype(np.float32),
                 gt_valid=np.ones((B, T), np.float32), sem_seg=sem)
    batch["gt_valid"][-1, -1] = 0.0
    return batch


def _rba_tpu_step(jcfg, params, batch, key):
    """rba_tpu's ``make_train_step`` ``loss_fn`` under ``jax.value_and_grad``, jitted."""
    def loss_fn(p, b):
        images = jmf.preprocess(jcfg, b["images"])
        if jcfg.sem_seg_head_name != "MaskFormerHead":
            logits, aux = jmf.per_pixel_forward(p, jcfg, images)
            losses = dict(jbh.per_pixel_losses(jcfg, key, logits, aux, b["sem_seg"]))
            losses["total"] = sum(losses.values())
        else:
            outputs = jmf.maskformer_forward(p, jcfg, images)
            losses = jcrit.criterion(jcfg, key, outputs, {k: v for k, v in b.items() if k != "images"})
        return losses["total"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(params), {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in losses.items()}, jax_params_to_state(jax.tree_util.tree_map(np.asarray, grads))


def _per_pixel_draws(key, loss_cfg, n_layers: int):
    """rba_tpu's ``per_pixel_losses`` draws in the port's order: per layer, final first,
    the candidates and then the random points."""
    n_unc = int(loss_cfg.importance_sample_ratio * loss_cfg.train_num_points)
    draws = []
    for k in jax.random.split(key, n_layers):
        k1, k2 = jax.random.split(k)
        draws.append(jax.random.uniform(k1, (B, int(loss_cfg.train_num_points * loss_cfg.oversample_ratio), 2)))
        if loss_cfg.train_num_points - n_unc > 0:
            draws.append(jax.random.uniform(k2, (B, loss_cfg.train_num_points - n_unc, 2)))
    return draws


@pytest.fixture(scope="module", params=list(HEADS))
def step_pair(request):
    name = request.param
    jcfg, tcfg = head_cfg(jconfig, name), head_cfg(tconfig, name)
    params = jconvert(d2_state_dict(tcfg, 4), jcfg)
    params["sem_seg_head"]["predictor"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(PREDICTOR_SCALE), params["sem_seg_head"]["predictor"])
    model = load_jax_params(tmf.build_model(tcfg, device="cpu"), params)
    batch, key = _batch(1), jax.random.PRNGKey(5)
    want, want_grads = _rba_tpu_step(jcfg, params, batch, key)
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in batch.items()}
    x = tmf.preprocess(tcfg, tb["images"])
    if tmf.is_per_pixel(tcfg):
        logits, aux = tmf.per_pixel_forward(model, tcfg, x, attention="xla")
        uniform = replay(_per_pixel_draws(key, tcfg.loss, 1 + len(aux)) if tcfg.loss.use_point_rend else [])
        losses = tbh.per_pixel_losses(tcfg, uniform, logits, aux, tb["sem_seg"])
        losses["total"] = sum(losses.values())
    else:
        outputs = tmf.maskformer_forward(model, tcfg, x, need_aux=True, attention="xla")
        uniform = replay(criterion_draws(key, tcfg.loss, B, T, 1 + len(outputs["aux_outputs"])))
        losses = tcrit.criterion(tcfg, uniform, outputs, {k: v for k, v in tb.items() if k != "images"})
    assert not uniform.left
    losses["total"].backward()
    got_grads = {n: p.grad.numpy().copy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
                 for n, p in model.named_parameters()}
    got = {k: float(v.detach()) for k, v in losses.items()}
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, params=params, model=model, batch=batch, want=want, got=got,
                want_grads=want_grads, got_grads=got_grads)


def test_losses_and_gradients_match_rba_tpu(step_pair, request):
    p = step_pair
    assert sorted(p["got"]) == sorted(p["want"])
    if p["name"] == "v1":  # the criterion supervises each of the 2 decoder layers
        assert "loss_ce_0" in p["got"] and "loss_ce_1" not in p["got"]
    if p["name"] == "plus":  # the second decoder layer's loss and the first's
        assert sorted(p["got"]) == ["loss_sem_seg", "loss_sem_seg_0", "total"]
    loss_err = max(abs(p["got"][k] - w) / max(1.0, abs(w)) for k, w in p["want"].items())
    assert sorted(p["got_grads"]) == sorted(p["want_grads"])
    zero = [n for n, heads in ZERO.items() if p["name"] in heads]
    scale = max(float(np.abs(w).max()) for w in p["want_grads"].values())
    errs = {n: float(np.abs(p["got_grads"][n] - w).max() / max(np.abs(w).max(), 1e-30))
            for n, w in p["want_grads"].items() if n not in zero}
    worst = max(errs, key=errs.get)
    noise = max((float(np.abs(g[n]).max()) for g in (p["got_grads"], p["want_grads"]) for n in zero), default=0.0)
    record(request, loss_rel_err=loss_err, grad_rel_err=errs[worst], zero_leaf_noise=noise / scale, leaves=len(errs))
    assert loss_err <= LOSS_TOL, p["got"]
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert noise <= NOISE * scale


def test_optimizer_partition_and_step(step_pair):
    """Every leaf in rba_tpu's (multiplier, decay) group, then one ``make_train_step`` of the
    port: finite metrics and every parameter moved."""
    p = step_pair
    jcfg, tcfg, model = p["jcfg"], p["tcfg"], p["model"]
    paths = []
    jax.tree_util.tree_map_with_path(lambda path, _: paths.append(jopt._path_str(path)), p["params"])
    group = {id(q): (g["lr_mult"], g["weight_decay"] > 0) for g in topt.param_groups(tcfg, model) for q in g["params"]}
    named = dict(model.named_parameters())
    assert sorted(jax_path(n, q.dim()) for n, q in named.items()) == sorted(paths)
    for n, q in named.items():
        path = jax_path(n, q.dim())
        want_mult = jcfg.solver.backbone_multiplier if jopt._is_backbone(path) else 1.0
        assert group[id(q)] == (want_mult, not jopt._is_no_decay(path)), n
    before = {n: q.detach().clone() for n, q in model.named_parameters()}
    state = tts.make_train_state(tcfg, model=model, seed=0)
    metrics = tts.make_train_step(tcfg)(state, p["batch"])
    assert all(np.isfinite(float(v)) for v in metrics.values())
    # every parameter with a gradient moved (a leaf with none and no decay may stay)
    assert all(not torch.equal(q, before[n]) for n, q in model.named_parameters() if np.any(p["want_grads"][n]))
