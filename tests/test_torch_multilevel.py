"""The three-level path against rba_tpu on the CPU: a tiny config with the COCO
open-panoptic model's structure (res3-res5 deformable levels, a masked decoder whose
layers cycle over the three levels) converted from one seeded Detectron2 dict.

- fp32: ``maskformer_forward``'s pred_logits / pred_masks and ``maskformer_infer``'s
  sem_seg within 1e-4 (rba_tpu jitted: at fp32 it computes the op-by-op function).
- ``fast_serving``: the one-hot bf16 sampling over the three levels within fp32
  rounding, and sem_seg within one bf16 ulp on >= 0.999 of the elements (the share
  ``tests/test_torch_fast_serving.py`` holds), against rba_tpu compiled so that each op
  rounds (its op-by-op function, the port's contract).
- The Detectron2 conversion of a three-level, 9-layer dict and its ``params.npz`` bit
  for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.convert import d2_mapping as jd2
from rba_tpu.convert.checkpoint import load_params as jload_params
from rba_tpu.models import maskformer as jmf
from rba_tpu.ops import deform_sampling as jds
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import d2_mapping as td2
from rba_tpu_torch.convert import load_params, save_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.ops import deform_sampling as tds
from tests.torch_port_common import (assert_trees_equal, d2_model_pair, d2_state_dict, equal_share, max_abs, record, t,
                                     ulp_share)

FP32_TOL = 1e-4
SAMPLING_RTOL = 1e-5  # relative to the largest output: fp32 sums in another order
FAST_SHARE = 0.999
HW = (96, 130)  # pads to 96x160: levels of 6x10, 3x5 and 2x3 (res5 below Swin's window)


def three_levels(pkg, dec_layers: int = 4):
    base = pkg.tiny_test_config()
    return dataclasses.replace(
        base,
        swin=dataclasses.replace(base.swin, depths=(2, 2, 2, 2), num_heads=(2, 4, 4, 8),
                                 out_features=("res2", "res3", "res4", "res5")),
        pixel_decoder=dataclasses.replace(base.pixel_decoder, transformer_in_features=("res3", "res4", "res5"),
                                          in_features=("res2", "res3", "res4", "res5")),
        decoder=dataclasses.replace(base.decoder, num_feature_levels=3, dec_layers=dec_layers))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = three_levels(jconfig), three_levels(tconfig)
    params, model = d2_model_pair(jcfg, tcfg, seed=0)
    img = (np.random.RandomState(0).rand(1, *HW, 3) * 255).astype(np.float32)
    return jcfg, tcfg, params, model, img


def test_forward_and_sem_seg_match_rba_tpu_at_fp32(pair, request):
    jcfg, tcfg, params, model, img = pair

    def f(p, x):
        return jmf.maskformer_forward(p, jcfg, jmf.preprocess(jcfg, x)), jmf.maskformer_infer(p, jcfg, x)["sem_seg"]

    want, want_sem = jax.jit(f)(params, jnp.asarray(img))
    with torch.no_grad():
        got = tmf.maskformer_forward(model, tcfg, tmf.preprocess(tcfg, t(img)))
    got_sem = tmf.maskformer_infer(model, tcfg, t(img))["sem_seg"]
    diffs = {k: max_abs(got[k], want[k]) for k in ("pred_logits", "pred_masks")}
    diffs["sem_seg"] = max_abs(got_sem, want_sem)
    record(request, **diffs)
    assert got["pred_masks"].shape == (1, tcfg.decoder.num_queries, HW[0] // 4, 160 // 4)
    assert all(v <= FP32_TOL for v in diffs.values()), diffs


def _level_inputs(tcfg, rng):
    """Sampling inputs at the model's three level shapes (6x10, 3x5, 2x3) and its heads."""
    shapes = [(6, 10), (3, 5), (2, 3)]
    n, m, d, p = 1, tcfg.pixel_decoder.transformer_nheads, 16, tcfg.pixel_decoder.enc_n_points
    lq = sum(h * w for h, w in shapes)
    value = rng.randn(n, lq, m, d).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (n, lq, m, len(shapes), p, 2)).astype(np.float32)
    loc[..., 1, :] = loc[..., 0, :] + 0.002  # points 0 and 1 share their corners
    aw = rng.rand(n, lq, m, len(shapes), p).astype(np.float32)
    aw /= aw.sum(axis=(-2, -1), keepdims=True)
    return shapes, value, loc, aw


def test_onehot_sampling_over_three_levels_matches_rba_tpu(pair, rng, request):
    """fast_serving's "auto" takes the one-hot bf16 form on every level at these shapes,
    as rba_tpu's dispatch does; its output is within fp32 rounding of rba_tpu's."""
    _, tcfg, _, _, _ = pair
    fcfg = tconfig.fast_serving(tcfg).pixel_decoder
    shapes, value, loc, aw = _level_inputs(tcfg, rng)
    n, lq, m = value.shape[0], value.shape[1], value.shape[2]
    assert tds.sampling_methods(n, m, lq, shapes, "auto", fcfg.sampling_onehot_cap) == ("onehot",) * 3
    want = np.asarray(jds.ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw),
                                              method="auto", sampling_dtype="bfloat16",
                                              onehot_cap=fcfg.sampling_onehot_cap))
    got = tds.ms_deform_attn_core(t(value), shapes, t(loc), t(aw), method="auto", sampling_dtype="bfloat16",
                                  onehot_cap=fcfg.sampling_onehot_cap)
    gather = tds.ms_deform_attn_core(t(value), shapes, t(loc), t(aw), method="gather")
    record(request, max_abs=max_abs(got, want), equal_share=equal_share(got, want),
           gather_vs_onehot_bf16=max_abs(gather, got))
    assert max_abs(got, want) <= SAMPLING_RTOL * np.abs(want).max()


def test_fast_serving_sem_seg_matches_rba_tpu(pair, request):
    jcfg, tcfg, params, model, img = pair
    fj, ft = jconfig.fast_serving(jcfg), tconfig.fast_serving(tcfg)
    # rba_tpu compiled so that every op rounds as its jaxpr says (ROADMAP.md §C.3)
    f = jax.jit(lambda p, x: jmf.maskformer_infer(p, fj, x)["sem_seg"],
                compiler_options={"xla_allow_excess_precision": False})
    want = f(params, jnp.asarray(img))
    got = tmf.maskformer_infer(model, ft, t(img), attention="xla")["sem_seg"]
    record(request, ulp_share=ulp_share(got, want), equal_share=equal_share(got, want), max_abs=max_abs(got, want))
    assert ulp_share(got, want) >= FAST_SHARE


def test_d2_conversion_of_nine_layers_bit_for_bit(tmp_path):
    """A three-level, 9-layer Detectron2 dict converts to rba_tpu's tree leaf for leaf, and
    the port's params.npz of it is what rba_tpu reads (and the other way round)."""
    jcfg, tcfg = three_levels(jconfig, dec_layers=9), three_levels(tconfig, dec_layers=9)
    sd = d2_state_dict(tcfg, seed=1)
    got, want = td2.convert_d2_state_dict(sd, tcfg), jd2.convert_d2_state_dict(sd, jcfg)
    assert_trees_equal(got, want)
    assert len(got["sem_seg_head"]["predictor"]["cross_layers"]) == 9
    save_params(str(tmp_path / "params.npz"), got)
    assert_trees_equal(jload_params(str(tmp_path / "params.npz")), want)
    assert_trees_equal(load_params(str(tmp_path / "params.npz")), want)
