"""The port's serving path at swin_b_1dl full width and depth against rba_tpu on the
CPU, fp32, on a 64x128 image, with rba_tpu's parameters carried over by
``load_jax_params``.  Both of the port's paths run on the same weights:

- path 1, ``attention="fused"`` (Kernel A's branch), ``mlp_impl="xla"``;
- path 2, ``attention="fused_softmax"`` (Kernel C's branch) with ``mlp_impl="fused"``
  (Kernel D on stages 0 and 1).

On the CPU rba_tpu takes neither kernel branch, so both are held against its one
XLA chain, which computes the same function.

Bound on the score map: 1e-3, the bound of rba_tpu's selfcheck
(rba_tpu/tools/selfcheck.py run_selfcheck ``tol``).  Measured when written:
3.4e-5 on path 1, 3.9e-5 on path 2.

At ``fast_serving`` (bf16 backbone and pixel-decoder inputs) the port's ``"xla"``
branch, rba_tpu's default chain, is held against rba_tpu called op by op: the whole
map at rba_tpu's own fast-vs-fp32 difference on the same image, and each half of the
path at a bound that its parity counterpart misses.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu.models import swin as jswin
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import maskformer as tmf
from tests.torch_port_common import max_abs, model_pair, record, t, to_np, ulp_share

SCORE_TOL = 1e-3
# fast_serving, held where the two packages' bf16 flips have not spread.  Least share
# within one bf16 ulp of the port's backbone outputs against rba_tpu's at fast_math on
# the same input; measured when written: res2 0.99678, res3 0.88879 (without
# fast_math 0.95686, 0.78183).
FAST_BACKBONE_SHARE = {"res2": 0.99, "res3": 0.85}
# The score map of the rest of the path (the bf16 pixel decoder, the one-hot bf16
# sampling, the decoder and the RbA tail) on rba_tpu's backbone features, against
# rba_tpu's fast map: mean and largest difference.  Measured when written: 1.02e-3
# and 1.17e-2 (with the parity pixel decoder 1.25e-2 and 0.102).
FAST_TAIL_MEAN, FAST_TAIL_MAX = 3e-3, 3e-2


@pytest.fixture(scope="module")
def swin_b_pair():
    """rba_tpu's swin_b_1dl parameters and the port's model holding them, and one 64x128
    image."""
    params, model = model_pair(jconfig.swin_b_1dl(), tconfig.swin_b_1dl(), seed=3)
    img = (np.random.RandomState(0).rand(1, 64, 128, 3) * 255).astype(np.float32)
    return params, model, img


@pytest.fixture(scope="module")
def swin_b_fp32(swin_b_pair):
    """rba_tpu's score map of one 64x128 image, and the port's model and config on the
    same parameters."""
    params, model, img = swin_b_pair
    jcfg = dataclasses.replace(jconfig.swin_b_1dl(), compute_dtype="float32")
    tcfg = dataclasses.replace(tconfig.swin_b_1dl(), compute_dtype="float32")
    want = jmf.maskformer_infer_rba(params, jcfg, jnp.asarray(img))
    return tcfg, model, img, want


def _check(request, got, want):
    assert got.shape == (1, 64, 128)
    assert np.isfinite(got.numpy()).all()
    record(request, max_abs=max_abs(got, want))
    assert max_abs(got, want) < SCORE_TOL


def test_swin_b_full_width_infer_rba_matches(swin_b_fp32, request):
    tcfg, model, img, want = swin_b_fp32
    _check(request, tmf.maskformer_infer_rba(model, tcfg, t(img)), want)


def test_swin_b_full_width_path2_matches(swin_b_fp32, request):
    tcfg, model, img, want = swin_b_fp32
    cfg2 = dataclasses.replace(tcfg, swin=dataclasses.replace(tcfg.swin, mlp_impl="fused"))
    _check(request, tmf.maskformer_infer_rba(model, cfg2, t(img), attention="fused_softmax"), want)


def test_swin_b_full_width_fast_serving_xla_matches(swin_b_pair, swin_b_fp32, request, monkeypatch):
    """At fast_serving, a one-ulp flip of one bf16 rounding (fp32 sums in another order,
    exp in its last bit) moves about 8 % of the outputs of the next 512-wide product by
    an ulp, so through 24 random-weight blocks the two packages' bf16 maps part about as
    far as each parts from its fp32 map.  The whole map is held at that yardstick: no
    further from rba_tpu's, by the mean over the pixels, than rba_tpu's fast map is from
    its fp32 map, nor by the largest difference more than twice as far.  Measured when
    written: mean 0.0197 against 0.0314, largest 0.335 against 0.311.

    A port that ran the parity path would sit near that distance too, so each half of
    the path is held also where the flips have not spread: the backbone's first two
    outputs (FAST_BACKBONE_SHARE), and the rest of the path on rba_tpu's own backbone
    features (FAST_TAIL_MEAN, FAST_TAIL_MAX).  The test checks that the parity
    counterpart of each half misses its bound."""
    params, model, img = swin_b_pair
    want32 = np.asarray(swin_b_fp32[3])
    jcfg, tcfg = jconfig.fast_serving(jconfig.swin_b_1dl()), tconfig.fast_serving(tconfig.swin_b_1dl())
    want = np.asarray(jmf.maskformer_infer_rba(params, jcfg, jnp.asarray(img)))
    got = tmf.maskformer_infer_rba(model, tcfg, t(img), attention="xla").numpy()
    assert got.shape == (1, 64, 128) and np.isfinite(got).all()
    d, ref = np.abs(got - want), np.abs(want - want32)
    record(request, mean_abs=d.mean(), max_abs=d.max(), ref_fast_vs_fp32_mean_abs=ref.mean(),
           ref_fast_vs_fp32_max_abs=ref.max())
    assert d.mean() <= ref.mean()
    assert d.max() <= 2 * ref.max()

    # rba_tpu's fast backbone on the port's own (normalized, padded) input, in place of
    # the port's; the port's backbone, with and without fast_math, beside it
    port_swin, seen = tmf.swin_apply, {}

    def rba_tpu_backbone(backbone, scfg, images, dtype, **kw):
        feats = jswin.swin_apply(params["backbone"], jcfg.swin, jnp.asarray(images.numpy()),
                                 compute_dtype=jnp.bfloat16, fast_math=True)
        seen["shares"] = {
            fast_math: {k: ulp_share(port_swin(backbone, scfg, images, dtype, attention="xla",
                                               fast_math=fast_math)[k], feats[k]) for k in FAST_BACKBONE_SHARE}
            for fast_math in (True, False)}
        return {k: torch.from_numpy(to_np(v)).to(torch.bfloat16) for k, v in feats.items()}

    monkeypatch.setattr(tmf, "swin_apply", rba_tpu_backbone)
    tail = tmf.maskformer_infer_rba(model, tcfg, t(img), attention="xla").numpy()
    shares = seen["shares"]
    tail_parity = tmf.maskformer_infer_rba(model, tconfig.swin_b_1dl(), t(img), attention="xla").numpy()
    dt, dp = np.abs(tail - want), np.abs(tail_parity - want)
    record(request, tail_mean_abs=dt.mean(), tail_max_abs=dt.max(), parity_tail_mean_abs=dp.mean(),
           parity_tail_max_abs=dp.max(), **{f"ulp_share_{k}{'' if fm else '_without_fast_math'}": v
                                            for fm, by in shares.items() for k, v in by.items()})
    for k, floor in FAST_BACKBONE_SHARE.items():
        assert shares[True][k] >= floor > shares[False][k], k
    assert dt.mean() <= FAST_TAIL_MEAN < dp.mean()
    assert dt.max() <= FAST_TAIL_MAX < dp.max()
