"""Weight-only int8 (``rba_tpu_torch/ops/quant.py``) against rba_tpu's ``ops/quant.py`` on the
CPU, from one seeded Detectron2 dict (``d2_model_pair``):

- which layers are quantized, their ``kernel_q`` and ``kscale`` and ``count_quantized``:
  bit for bit equal to rba_tpu's, under its skip rules (``in_proj``, ``patch_embed``,
  MViT's ``proj``, fc1 / fc2 under ``mlp_impl="fused"``) at ``min_dim`` 64 and 16;
- ``maskformer_infer_rba`` at fp32 on the int8 model within 1e-5 of rba_tpu's on its int8
  tree (jitted);
- one int8 linear at bf16 equal to rba_tpu's ``linear`` called op by op, bit for bit;
- ``load_jax_params`` of rba_tpu's int8 tree gives the port's int8 model, and
  ``model_to_jax_params`` gives the tree back;
- ``OODEvaluator`` under ``weight_quant="int8"`` scores an int8 copy and leaves the model
  as it was."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu.ops import nn as jnn
from rba_tpu.ops import quant as jquant
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert.params import load_jax_params, model_to_jax_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.ops import nn as tnn
from rba_tpu_torch.ops import quant as tquant
from tests.torch_port_common import d2_model_pair, jax_config, max_abs, t

SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    tcfg = tconfig.tiny_test_config()
    jcfg = jax_config(tcfg)
    params, model = d2_model_pair(jcfg, tcfg, seed=2)
    return jcfg, tcfg, params, model


def _quantized_leaves(tree, path=()):
    """{path: (kernel_q, kscale)} of rba_tpu's int8 layers."""
    out = {}
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            return {path: (np.asarray(tree["kernel_q"]), np.asarray(tree["kscale"]))}
        for k, v in tree.items():
            out.update(_quantized_leaves(v, path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_quantized_leaves(v, path + (str(i),)))
    return out


VARIANTS = {"default": {}, "mvit": dict(backbone_name="mvit"), "fused_mlp": "fused"}


@pytest.mark.parametrize("min_dim", [64, 16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_quantization_matches_rba_tpu(pair, variant, min_dim):
    jcfg, tcfg, params, model = pair
    change = VARIANTS[variant]
    if change == "fused":
        qj = dataclasses.replace(jcfg, swin=dataclasses.replace(jcfg.swin, mlp_impl="fused"))
        qt = dataclasses.replace(tcfg, swin=dataclasses.replace(tcfg.swin, mlp_impl="fused"))
    else:
        qj, qt = dataclasses.replace(jcfg, **change), dataclasses.replace(tcfg, **change)
    want_tree = jquant.quantize_params_int8(params, min_dim=min_dim, cfg=qj)
    got_model = tquant.quantize_params_int8(model, min_dim=min_dim, cfg=qt)
    want = _quantized_leaves(want_tree)
    got = {tuple(n.split(".")): (m.kernel_q.numpy().T, m.kscale.numpy())
           for n, m in got_model.named_modules() if hasattr(m, "kernel_q")}
    assert got.keys() == want.keys() and len(got) > 0
    for path, (q, s) in want.items():
        assert got[path][0].dtype == np.int8 and np.array_equal(got[path][0], q), path
        assert np.array_equal(got[path][1], s), path
    assert tquant.count_quantized(got_model) == jquant.count_quantized(want_tree)
    assert all(hasattr(m, "weight") for m in model.modules() if isinstance(m, torch.nn.Linear))  # a copy
    skipped = {p[-1] for p in _quantized_leaves(jquant.quantize_params_int8(params, min_dim=min_dim))} - \
        {p[-1] for p in want}
    if variant == "mvit" and min_dim == 16:
        assert "proj" in skipped
    if variant == "fused_mlp":
        assert {"fc1", "fc2"} <= skipped or min_dim == 64  # the tiny Swin's MLPs are narrower than 64


def test_int8_scores_match_rba_tpu(pair, rng):
    jcfg, tcfg, params, model = pair
    qcfg_j = dataclasses.replace(jcfg, weight_quant="int8")
    img = (rng.rand(1, 48, 64, 3) * 255).astype(np.float32)
    want = jax.jit(lambda p, x: jmf.maskformer_infer_rba(p, jcfg, x))(
        jquant.quantize_params_int8(params, cfg=qcfg_j), jnp.asarray(img))
    qmodel = tquant.quantize_params_int8(model, cfg=tcfg)
    with torch.no_grad():
        got = tmf.maskformer_infer_rba(qmodel, tcfg, t(img))
        fp = tmf.maskformer_infer_rba(model, tcfg, t(img))
    assert max_abs(got, want) < SCORE_TOL
    assert max_abs(got, fp) > SCORE_TOL  # the int8 weights move the scores


def test_int8_linear_bf16_equals_rba_tpu_op_by_op(rng):
    w = rng.randn(128, 96).astype(np.float32) * 0.05  # (out, in)
    b = rng.randn(128).astype(np.float32) * 0.1
    x = rng.randn(2, 7, 96).astype(np.float32)
    jp = jquant.quantize_linear_int8({"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)})
    want = jnn.linear(jp, jnp.asarray(x, jnp.bfloat16))  # op by op: every step rounded to bf16
    layer = torch.nn.Linear(96, 128)
    with torch.no_grad():
        layer.weight.copy_(t(w))
        layer.bias.copy_(t(b))
    tquant.set_quantized(layer, *tquant.quantize_linear_int8(layer.weight))
    with torch.no_grad():
        got = tnn.apply_linear(layer, t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_load_jax_params_takes_an_int8_tree(pair, rng):
    jcfg, tcfg, params, model = pair
    tree = jquant.quantize_params_int8(params, cfg=jcfg)
    loaded = load_jax_params(tmf.build_model(tcfg, device="cpu", seed=0), tree)
    want = tquant.quantize_params_int8(model, cfg=tcfg)
    got = dict(loaded.named_buffers())
    for name, buf in want.named_buffers():
        if name.endswith((".kernel_q", ".kscale")):
            assert got[name].dtype == buf.dtype and torch.equal(got[name], buf), name
    img = t((rng.rand(1, 32, 48, 3) * 255).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tmf.maskformer_infer_rba(loaded, tcfg, img), tmf.maskformer_infer_rba(want, tcfg, img))
    back = _quantized_leaves(model_to_jax_params(loaded))
    for path, (q, s) in _quantized_leaves(tree).items():
        assert np.array_equal(back[path][0], q) and np.array_equal(back[path][1], s), path


def test_evaluator_scores_an_int8_copy(pair):
    from rba_tpu_torch.data.ood_datasets import SyntheticAnomaly
    from rba_tpu_torch.evalx.evaluator import OODEvaluator

    _, tcfg, _, model = pair
    ev = OODEvaluator(dataclasses.replace(tcfg, weight_quant="int8"), model)
    assert tquant.is_quantized(ev.model) and not tquant.is_quantized(model)
    scores, _ = ev.compute_anomaly_scores(SyntheticAnomaly(n=1, hw=(32, 48)))
    with torch.no_grad():
        want = tmf.maskformer_infer_rba(tquant.quantize_params_int8(model, cfg=tcfg), tcfg,
                                        t(SyntheticAnomaly(n=1, hw=(32, 48))[0].image[None].astype(np.float32)))
    assert np.array_equal(scores, want.numpy())
