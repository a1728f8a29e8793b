"""The port's serving path end to end against rba_tpu on the CPU at fp32.

Bound on the score map: 1e-3, the bound of rba_tpu's selfcheck
(rba_tpu/tools/selfcheck.py run_selfcheck ``tol``).  The full-width Swin-B case is
in tests/test_torch_swin_b_full_width.py, so that it runs beside this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu.models import pixel_decoder as jpd
from rba_tpu.models import transformer_decoder as jtd
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import pixel_decoder as tpd
from rba_tpu_torch.models import transformer_decoder as ttd
from tests.torch_port_common import d2_model_pair, jax_config, max_abs, t

SCORE_TOL = 1e-3


def _jit(fn, cfg, **kw):
    """rba_tpu's fp32 ``fn(params, cfg, images, **kw)``, jitted: the same function,
    compiled once instead of op by op for each image shape."""
    return jax.jit(lambda p, x: fn(p, cfg, x, **kw))


@pytest.fixture(scope="module")
def tiny():
    return d2_model_pair(jconfig.tiny_test_config(), tconfig.tiny_test_config(), seed=0)


def test_config_presets_agree():
    for name in ("swin_b_1dl", "swin_l_1dl", "tiny_test_config"):
        j, p = getattr(jconfig, name)(), getattr(tconfig, name)()
        sections = ("swin", "resnet", "pixel_decoder", "decoder", "input", "test", "ood", "loss", "solver")
        for sect in sections:
            tj, tp = getattr(j, sect), getattr(p, sect)
            for f in dataclasses.fields(tp):
                assert getattr(tp, f.name) == getattr(tj, f.name), (name, sect, f.name)
        for f in dataclasses.fields(p):
            if f.name not in sections:
                assert getattr(p, f.name) == getattr(j, f.name), (name, f.name)


def test_preprocess_matches(rng):
    img = (rng.rand(2, 50, 70, 3) * 255).astype(np.float32)
    want = jmf.preprocess(jconfig.tiny_test_config(), jnp.asarray(img))
    got = tmf.preprocess(tconfig.tiny_test_config(), t(img))
    assert got.shape == (2, 64, 96, 3)
    assert max_abs(got, want) < 1e-5


@pytest.mark.parametrize("include_void", [False, True])
def test_semantic_inference_and_rba_score_match(rng, include_void):
    mask_cls = rng.randn(2, 10, 8).astype(np.float32)
    mask_pred = (rng.randn(2, 10, 12, 20) * 2).astype(np.float32)
    want = jmf.semantic_inference(jnp.asarray(mask_cls), jnp.asarray(mask_pred), include_void=include_void)
    got = tmf.semantic_inference(t(mask_cls), t(mask_pred), include_void=include_void)
    assert got.shape == (2, 8 if include_void else 7, 12, 20)
    assert max_abs(got, want) < 1e-5
    assert max_abs(tmf.rba_score(got), jmf.rba_score(want)) < 1e-5


def test_pixel_decoder_matches(tiny, rng):
    params, model = tiny
    feats = {"res2": rng.randn(2, 16, 24, 32).astype(np.float32), "res3": rng.randn(2, 8, 12, 64).astype(np.float32)}
    jcfg = jconfig.tiny_test_config().pixel_decoder
    want = jpd.pixel_decoder_apply(params["sem_seg_head"]["pixel_decoder"], jcfg,
                                   {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got = tpd.pixel_decoder_apply(model.sem_seg_head["pixel_decoder"], tconfig.tiny_test_config().pixel_decoder,
                                      {k: t(v) for k, v in feats.items()})
    assert max_abs(got[0], want[0]) < 1e-4
    assert max_abs(got[1], want[1]) < 1e-4


@pytest.mark.parametrize("layout", ["bqhw", "bhwq"])
def test_decoder_matches(tiny, rng, layout):
    params, model = tiny
    feats = rng.randn(2, 8, 12, 64).astype(np.float32)
    mf = rng.randn(2, 16, 24, 64).astype(np.float32)
    want = jtd.decoder_apply(params["sem_seg_head"]["predictor"], jconfig.tiny_test_config().decoder,
                             [jnp.asarray(feats)], jnp.asarray(mf), final_mask_layout=layout, need_aux=False)
    with torch.no_grad():
        got = ttd.decoder_apply(model.sem_seg_head["predictor"], tconfig.tiny_test_config().decoder, [t(feats)],
                                t(mf), final_mask_layout=layout)
    assert max_abs(got["pred_logits"], want["pred_logits"]) < 1e-4
    assert max_abs(got["pred_masks"], want["pred_masks"]) < 1e-4


def test_tiny_infer_rba_matches(tiny, rng):
    params, model = tiny
    img = (rng.rand(2, 50, 70, 3) * 255).astype(np.float32)
    want = _jit(jmf.maskformer_infer_rba, jconfig.tiny_test_config())(params, jnp.asarray(img))
    got = tmf.maskformer_infer_rba(model, tconfig.tiny_test_config(), t(img))
    assert got.shape == (2, 50, 70)
    assert max_abs(got, want) < SCORE_TOL


def test_tiny_infer_matches(tiny, rng):
    params, model = tiny
    img = (rng.rand(1, 48, 64, 3) * 255).astype(np.float32)
    want = _jit(jmf.maskformer_infer, jconfig.tiny_test_config(), out_hw=(97, 130))(params, jnp.asarray(img))
    got = tmf.maskformer_infer(model, tconfig.tiny_test_config(), t(img), out_hw=(97, 130))
    assert got["sem_seg"].shape == (1, 7, 97, 130)
    assert max_abs(got["sem_seg"], want["sem_seg"]) < 1e-4
    assert max_abs(got["rba"], want["rba"]) < SCORE_TOL
    # the fused tail is the same function as the unfused one at the input size
    rba = tmf.maskformer_infer_rba(model, tconfig.tiny_test_config(), t(img))
    assert max_abs(rba, tmf.maskformer_infer(model, tconfig.tiny_test_config(), t(img))["rba"]) < 1e-4


@pytest.mark.parametrize("change", [
    dict(backbone_name="no_such_backbone"), dict(param_dtype="bfloat16"),
    dict(decoder=dataclasses.replace(tconfig.tiny_test_config().decoder, pre_norm=True)),
    dict(weight_quant="int8"), dict(sem_seg_head_name="PerPixelBaselineHead"),
])
def test_unported_options_raise(change, rng):
    """An unknown backbone is refused, as rba_tpu refuses it.  Pre-norm and the per-pixel
    head (refused until §A.6 ported them), bf16 parameters and int8 weights (until §A.8)
    build and serve: from one seeded Detectron2 dict the score map equals rba_tpu's within
    1e-5 (the masked decoder has no pre-norm form: both packages run it post-norm; no
    model of either reads ``param_dtype``; ``maskformer_infer_rba`` serves the weights it
    is given, and the evaluator quantizes them, tests/test_torch_quant.py)."""
    tcfg = dataclasses.replace(tconfig.tiny_test_config(), **change)
    if tcfg.backbone_name == "no_such_backbone":
        with pytest.raises(NotImplementedError):
            tmf.build_model(tcfg, device="cpu")
        return
    jcfg = jax_config(tcfg)
    params, model = d2_model_pair(jcfg, tcfg, seed=1)
    img = (rng.rand(1, 48, 64, 3) * 255).astype(np.float32)
    want = _jit(jmf.maskformer_infer_rba, jcfg)(params, jnp.asarray(img))
    got = tmf.maskformer_infer_rba(model, tcfg, t(img))
    assert got.shape == (1, 48, 64) and max_abs(got, want) < 1e-5


def test_need_aux_raises(tiny):
    """Training through Kernel A's branch raises: the kernel has no gradient (training
    takes attention="xla"; tests/test_torch_train_step.py holds need_aux=True there)."""
    _, model = tiny
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tmf.maskformer_forward(model, tconfig.tiny_test_config(), x, need_aux=True)
