"""The port's serving path at swin_b_1dl full width and depth against rba_tpu on the
CPU, fp32, on a 64x128 image, with rba_tpu's parameters carried over by
``load_jax_params``.

Bound on the score map: 1e-3, the bound of rba_tpu's selfcheck
(rba_tpu/tools/selfcheck.py run_selfcheck ``tol``).  Measured when written:
3.4e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import maskformer as tmf
from tests.torch_port_common import max_abs, model_pair, t

SCORE_TOL = 1e-3


def test_swin_b_full_width_infer_rba_matches(rng):
    jcfg = dataclasses.replace(jconfig.swin_b_1dl(), compute_dtype="float32")
    tcfg = dataclasses.replace(tconfig.swin_b_1dl(), compute_dtype="float32")
    params, model = model_pair(jcfg, tcfg, seed=3)
    img = (rng.rand(1, 64, 128, 3) * 255).astype(np.float32)
    got = tmf.maskformer_infer_rba(model, tcfg, t(img))
    want = jmf.maskformer_infer_rba(params, jcfg, jnp.asarray(img))
    assert got.shape == (1, 64, 128)
    assert np.isfinite(got.numpy()).all()
    assert max_abs(got, want) < SCORE_TOL
