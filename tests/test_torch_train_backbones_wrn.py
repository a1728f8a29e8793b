"""Training WiderResNet-38 (stride 8, five pixel-decoder inputs at one stride, its
``bn1``/``bn2``/``bn3``/``bn_out`` statistics trained by gradient) under the narrow head:
the port against rba_tpu on the CPU (``tests/test_torch_train_backbones.py`` has the
setting).

- fp32, the whole step: each weighted loss within 1e-4, and every gradient of the pixel
  decoder and the decoder within 1e-4 relative to its leaf's largest magnitude.
- The backbone's gradient at fp32 is not a function that two summation orders can agree
  on to 1e-4 here: among its ReLU inputs at stride 8 (786 432 in ``res7_bn`` alone) some
  sit within rounding of zero, where the conv's summation order decides the mask, and
  one flipped ReLU moves a leaf's gradient by a whole product of cotangent and
  activation (the difference is recorded, ROADMAP.md §C.15).  So the backbone is held at
  fp64, where no ReLU input that the two packages compute rounds to
  the other side: on a 32 x 48 crop of the batch's first image, the gradient of every
  backbone parameter, the batch norms' ``mean`` and ``var`` included, and of the input,
  for a seeded cotangent on the five outputs, within 1e-4 relative to its leaf's largest
  magnitude.  Both packages round each batch norm's
  input to fp32 there, as they do at fp32.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.models import maskformer as jmf
from rba_tpu.models import wideresnet as jwrn
from rba_tpu_torch.convert.params import jax_params_to_state
from rba_tpu_torch.models import wideresnet as twrn
from rba_tpu_torch.models.transformer_decoder import BatchNormStats
from tests.torch_port_common import GRAD_TOL, TrainStepPair, assert_losses_match, grad_errors, record

OUTPUTS = ("res4", "res5", "res6", "res7", "res7_bn")


@pytest.fixture(scope="module")
def wrn():
    return TrainStepPair("wideresnet38")


def test_losses_match_rba_tpu(wrn, request):
    assert wrn.model.mask_stride(wrn.tcfg) == 8
    record(request, loss_rel_err=assert_losses_match(wrn))


def test_head_gradients_match_rba_tpu(wrn, request):
    errs = grad_errors(wrn.got_grads, wrn.want_grads)
    head = {n: e for n, e in errs.items() if not n.startswith("backbone.")}
    worst = max(head, key=head.get)
    backbone = max(e for n, e in errs.items() if n.startswith("backbone."))
    record(request, grad_rel_err=head[worst], backbone_fp32_grad_rel_err=backbone, leaves=len(head))
    assert head[worst] <= GRAD_TOL, (worst, head[worst])
    # the five inputs at one stride each take their gradient through the FPN or the encoder
    assert len([n for n in head if n.startswith("sem_seg_head.pixel_decoder.") and n.endswith("lateral.conv.weight")]) \
        == 4


def test_backbone_gradients_at_fp64_match_rba_tpu(wrn, request):
    # the batch's first image, its top-left 32 x 48 (a 4 x 6 map at stride 8): fp64 convs are slow on the CPU
    x = np.asarray(jmf.preprocess(wrn.jcfg, jnp.asarray(wrn.batch["images"][:1, :32, :48]))).astype(np.float64)
    model = copy.deepcopy(wrn.model.backbone).double()
    tx = torch.from_numpy(x).requires_grad_()
    outs = twrn.wideresnet_apply(model, tx, torch.float64)
    rs = np.random.RandomState(2)
    cot = {k: rs.randn(*outs[k].shape) for k in OUTPUTS}
    sum((outs[k] * torch.from_numpy(cot[k])).sum() for k in OUTPUTS).backward()
    got = {"backbone." + n: p.grad.numpy() for n, p in model.named_parameters()}
    got["input"] = tx.grad.numpy()

    def loss(p, images, c):  # the cotangents an argument: XLA would fold convs of constants
        o = jwrn.wideresnet_apply(p, jwrn.WideResNetConfig(), images, jnp.float64)
        return sum(jnp.sum(o[k] * c[k]) for k in OUTPUTS)

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), wrn.params["backbone"])
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x), cot)
        assert gx.dtype == jnp.float64
        want = {k: np.asarray(v) for k, v in jax_params_to_state({"backbone": gp}).items()}
        want["input"] = np.asarray(gx)
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    record(request, grad_rel_err=errs[worst], leaves=len(errs))
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    norms = sum(isinstance(m, BatchNormStats) for m in model.modules())
    assert norms == 37 and sum(n.endswith((".mean", ".var")) for n in errs) == 2 * norms
