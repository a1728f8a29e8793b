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
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import maskformer as tmf
from tests.torch_port_common import max_abs, model_pair, record, t

SCORE_TOL = 1e-3


@pytest.fixture(scope="module")
def swin_b_fp32():
    """rba_tpu's score map of one 64x128 image, and the port's model and config on the
    same parameters."""
    jcfg = dataclasses.replace(jconfig.swin_b_1dl(), compute_dtype="float32")
    tcfg = dataclasses.replace(tconfig.swin_b_1dl(), compute_dtype="float32")
    params, model = model_pair(jcfg, tcfg, seed=3)
    img = (np.random.RandomState(0).rand(1, 64, 128, 3) * 255).astype(np.float32)
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
