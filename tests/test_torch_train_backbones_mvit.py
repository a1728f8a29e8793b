"""Training MViTv2 (the fixed in21k config: pooled attention, decomposed relative
positions, the windowed stride-4 stage) under the narrow head: the port against rba_tpu
on the CPU at fp32 (``tests/test_torch_train_backbones.py`` has the setting).  Each
weighted loss within 1e-4, every gradient within 1e-4 relative to its leaf's largest
magnitude.  One kind of leaf has no gradient in exact arithmetic: the bias of
``norm_k`` in a block of global attention (no padded window), since a vector added to
every key shifts each query's logits by one constant, which the softmax removes.  Both
packages give it rounding noise there; it is held to be noise on both sides (below 1e-6
of the model's largest gradient) instead of relative to itself.
"""
import numpy as np
import pytest

from tests.torch_port_common import GRAD_TOL, TrainStepPair, assert_losses_match, grad_errors, record

NOISE = 1e-6  # of the model's largest gradient: what an exactly zero gradient rounds to


@pytest.fixture(scope="module")
def mvit():
    return TrainStepPair("mvit")


def test_losses_match_rba_tpu(mvit, request):
    record(request, loss_rel_err=assert_losses_match(mvit))


def test_gradients_match_rba_tpu(mvit, request):
    pair = mvit
    sched = pair.model.backbone.sched
    zero = {f"backbone.blocks.{i}.attn.norm_k.bias" for i, s in enumerate(sched) if s["window"] == 0}
    assert len(zero) == 3  # the last blocks of stages 2-4
    errs = grad_errors(pair.got_grads, pair.want_grads)
    rest = {n: e for n, e in errs.items() if n not in zero}
    worst = max(rest, key=rest.get)
    scale = max(float(np.abs(g).max()) for g in pair.want_grads.values())
    noise = max(max(float(np.abs(pair.got_grads[n]).max()), float(np.abs(pair.want_grads[n]).max())) for n in zero)
    record(request, grad_rel_err=rest[worst], zero_leaf_noise=noise / scale, leaves=len(errs))
    assert rest[worst] <= GRAD_TOL, (worst, rest[worst])
    assert noise <= NOISE * scale
    # the windowed blocks' norm_k bias does have a gradient, held like every other leaf
    assert np.abs(pair.want_grads["backbone.blocks.0.attn.norm_k.bias"]).max() > 10 * NOISE * scale
