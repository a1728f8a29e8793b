"""The options that the port refused until it took them, each against rba_tpu at fp32 on
the CPU, from one seeded Detectron2 dict (``d2_model_pair``):

- ``pixel_decoder.norm`` other than "GN" (rba_tpu reads it and runs GroupNorm whatever it
  says), ``param_dtype="bfloat16"`` (no rba_tpu model reads it) and
  ``sampling_method="gather_scatter"`` (rba_tpu's plain-autodiff gather): the score map
  within 1e-5 of rba_tpu's with the same option, and equal bit for bit to the port's
  without it;
- Swin's ``attn_layout`` "nested", "resident", "qkv_canvas", "proj_canvas" and a
  per-stage "resident:0": the backbone's features within 1e-5 of rba_tpu's with that
  layout, and equal bit for bit to the partition layout's;
- ``use_checkpoint``: a training step's losses and gradients equal to those without it,
  bit for bit (the blocks' activations are recomputed in the backward);
- ``check_supported`` refuses only names that no registry holds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.models import maskformer as jmf
from rba_tpu.models import swin as jswin
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import swin as tswin
from tests.torch_parallel_ranks import train_batch, train_cfg, train_run
from tests.torch_port_common import d2_model_pair, jax_config, max_abs, t

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    tcfg = tconfig.tiny_test_config()
    jcfg = jax_config(tcfg)
    params, model = d2_model_pair(jcfg, tcfg, seed=4)
    img = (np.random.RandomState(0).rand(1, 48, 64, 3) * 255).astype(np.float32)
    with torch.no_grad():
        default = tmf.maskformer_infer_rba(model, tcfg, t(img))
    return tcfg, params, model, img, default


def _replace(cfg, option, value):
    if option in ("norm", "sampling_method"):
        return dataclasses.replace(cfg, pixel_decoder=dataclasses.replace(cfg.pixel_decoder, **{option: value}))
    return dataclasses.replace(cfg, **{option: value})


@pytest.mark.parametrize("option,value", [("norm", ""), ("param_dtype", "bfloat16"),
                                          ("sampling_method", "gather_scatter")])
def test_option_matches_rba_tpu(pair, option, value):
    tcfg, params, model, img, default = pair
    cfg = _replace(tcfg, option, value)
    tconfig.check_supported(cfg)
    jcfg = jax_config(cfg)
    want = jax.jit(lambda p, x: jmf.maskformer_infer_rba(p, jcfg, x))(params, jnp.asarray(img))
    with torch.no_grad():
        got = tmf.maskformer_infer_rba(model, cfg, t(img))
    assert max_abs(got, want) < TOL
    assert torch.equal(got, default)  # at fp32 the default "auto" sampling takes the gather too


@pytest.mark.parametrize("layout", ["nested", "resident", "qkv_canvas", "proj_canvas", "resident:0"])
def test_attn_layout_matches_rba_tpu(pair, layout):
    tcfg, params, model, img, _ = pair
    swin_cfg = dataclasses.replace(tcfg.swin, attn_layout=layout)
    tconfig.check_supported(dataclasses.replace(tcfg, swin=swin_cfg))
    x = (img - 128.0) / 64.0
    want = jax.jit(lambda p, x: jswin.swin_apply(p, jax_config(swin_cfg), x, compute_dtype=jnp.float32))(
        params["backbone"], jnp.asarray(x))
    with torch.no_grad():
        got = tswin.swin_apply(model.backbone, swin_cfg, t(x), torch.float32, attention="xla")
        partition = tswin.swin_apply(model.backbone, tcfg.swin, t(x), torch.float32, attention="xla")
    assert got.keys() == want.keys()
    for k in got:
        assert max_abs(got[k], want[k]) < TOL, k
        assert torch.equal(got[k], partition[k]), k


def test_use_checkpoint_gives_the_same_gradients():
    cfg = train_cfg()
    ckpt = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, use_checkpoint=True))
    batches = [train_batch(0, 2)]
    m0, g0, _ = train_run(cfg, batches, 1)
    m1, g1, _ = train_run(ckpt, batches, 1)
    assert m0 == m1
    assert g0.keys() == g1.keys()
    for n in g0:
        assert np.array_equal(g0[n], g1[n]), n


def test_use_checkpoint_recomputes_the_blocks(monkeypatch):
    """Under autograd each block runs twice (the forward, then its recomputation in the
    backward); without gradients once."""
    cfg = tconfig.tiny_test_config()
    swin_cfg = dataclasses.replace(cfg.swin, use_checkpoint=True)
    model = tmf.build_model(cfg, device="cpu", seed=0)
    calls = []
    real = tswin.swin_block_apply
    monkeypatch.setattr(tswin, "swin_block_apply", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(1, 32, 32, 3)
    out = tswin.swin_apply(model.backbone, swin_cfg, x, torch.float32, attention="xla")
    sum(v.sum() for v in out.values()).backward()
    assert len(calls) == 2 * sum(cfg.swin.depths)
    calls.clear()
    with torch.no_grad():
        tswin.swin_apply(model.backbone, swin_cfg, x, torch.float32, attention="xla")
    assert len(calls) == sum(cfg.swin.depths)


@pytest.mark.parametrize("change", [dict(backbone_name="no_such_backbone"),
                                    dict(swin=dataclasses.replace(tconfig.SwinConfig(), attn_layout="diagonal")),
                                    dict(weight_quant="int4")])
def test_unknown_names_are_refused(change):
    with pytest.raises(NotImplementedError, match="not in the registries"):
        tconfig.check_supported(dataclasses.replace(tconfig.tiny_test_config(), **change))
