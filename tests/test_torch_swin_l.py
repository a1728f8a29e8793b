"""Swin-L (``swin_l_1dl``: embed 192, heads 6/12/24/48) through the port's serving paths
against rba_tpu on the CPU, fp32, on a 64x128 image, with the depths cut to 2 per stage
and rba_tpu's parameters converted from one seeded Detectron2 dict:

- path 1, ``attention="fused"`` (Kernel A's branch), ``mlp_impl="xla"``;
- path 2, ``attention="fused_softmax"`` (Kernel C's branch) with ``mlp_impl="fused"``.

On the CPU rba_tpu takes neither kernel branch, so both are held against its XLA chain,
within 1e-4 on the score map.  Also: Kernel D's dispatch, ``supports`` and
``beneficial``, equals rba_tpu's at Swin-L's widths, where it takes no block."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rba_tpu import config as jconfig
from rba_tpu.models import maskformer as jmf
from rba_tpu.ops.pallas import fused_mlp as jfused_mlp
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.kernels import fused_mlp as tfused_mlp
from rba_tpu_torch.models import maskformer as tmf
from tests.torch_port_common import d2_model_pair, max_abs, record, t

SCORE_TOL = 1e-4
DEPTHS = (2, 2, 2, 2)


def _cut(pkg):
    cfg = pkg.swin_l_1dl()
    return dataclasses.replace(cfg, compute_dtype="float32", swin=dataclasses.replace(cfg.swin, depths=DEPTHS))


@pytest.fixture(scope="module")
def swin_l_fp32():
    jcfg, tcfg = _cut(jconfig), _cut(tconfig)
    assert (tcfg.swin.embed_dim, tcfg.swin.num_heads) == (192, (6, 12, 24, 48))
    params, model = d2_model_pair(jcfg, tcfg, seed=5)
    img = (np.random.RandomState(1).rand(1, 64, 128, 3) * 255).astype(np.float32)
    # jitted: the fp32 function, compiled once instead of op by op
    want = np.asarray(jax.jit(lambda p, x: jmf.maskformer_infer_rba(p, jcfg, x))(params, jnp.asarray(img)))
    return tcfg, model, img, want


@pytest.mark.parametrize("path", ["path1", "path2"])
def test_swin_l_infer_rba_matches(swin_l_fp32, path, request):
    tcfg, model, img, want = swin_l_fp32
    if path == "path1":
        got = tmf.maskformer_infer_rba(model, tcfg, t(img))
    else:
        cfg2 = dataclasses.replace(tcfg, swin=dataclasses.replace(tcfg.swin, mlp_impl="fused"))
        got = tmf.maskformer_infer_rba(model, cfg2, t(img), attention="fused_softmax")
    assert got.shape == (1, 64, 128) and np.isfinite(got.numpy()).all()
    record(request, max_abs=max_abs(got, want))
    assert max_abs(got, want) < SCORE_TOL


@pytest.mark.parametrize("c", [192, 384, 768, 1536])
def test_fused_mlp_dispatch_at_swin_l_widths(c):
    tokens = 16384
    assert tfused_mlp.supports(tokens, c) == jfused_mlp.supports(tokens, c)
    assert tfused_mlp.beneficial(tokens, c) == jfused_mlp.beneficial(tokens, c)
    assert not tfused_mlp.beneficial(tokens, c)  # 192: C % 128; 384 and above: C > 256
