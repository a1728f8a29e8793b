"""Training ViT (stride 16, one ``last_feat`` level): the port against rba_tpu on the CPU
at fp32 (``tests/test_torch_train_backbones.py`` has the setting).  The full ViT-B under
the narrow head: each weighted loss within 1e-4 and every gradient within 1e-4 relative
to its leaf's largest magnitude: the relative-position tables through their cached
gather indices and resampling weights (``vit._rel_pos_constants``, made outside
inference mode) and the bicubic-resized position table.  The SimpleFeaturePyramid's 2x2
transposed convs, whose kernel the port flips for torch's ``conv_transpose2d`` where
``lax.conv_transpose`` does not, alone against rba_tpu's ``_conv_transpose``; the whole
ViT + SFP model in ``tests/test_torch_train_backbones_vit_sfp.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rba_tpu.models import vit as jvit
from rba_tpu_torch.models import vit as tvit
from tests.torch_port_common import TrainStepPair, assert_gradients_match, assert_losses_match, record, t


@pytest.fixture(scope="module")
def vit():
    return TrainStepPair("vit")


def test_losses_match_rba_tpu(vit, request):
    assert vit.model.mask_stride(vit.tcfg) == 16
    record(request, loss_rel_err=assert_losses_match(vit))


def test_gradients_match_rba_tpu(vit, request):
    grads = assert_gradients_match(vit, request)
    for name in ("pos_embed", "blocks.0.attn.rel_pos_h", "blocks.2.attn.rel_pos_w"):
        assert np.abs(grads["backbone." + name]).max() > 0, name


def test_sfp_conv_transpose_gradient_matches_rba_tpu():
    """``conv_transpose2x`` (kernel flipped for torch) against rba_tpu's ``_conv_transpose``:
    output within 1e-5 and the gradients of input, kernel and bias within 1e-5 of the
    largest, on a seeded (2, 3, 5, 8) map."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 5, 8).astype(np.float32)
    kernel = rs.randn(2, 2, 8, 6).astype(np.float32)  # HWIO, as rba_tpu keeps it
    bias = rs.randn(6).astype(np.float32)
    cot = rs.randn(2, 6, 10, 6).astype(np.float32)

    def jloss(x, k, b):
        return jnp.sum(jvit._conv_transpose({"kernel": k, "bias": b}, x) * cot)

    want_out = jvit._conv_transpose({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}, jnp.asarray(x))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, kernel, bias)))
    conv = nn.Conv2d(8, 6, 2)
    with torch.no_grad():  # the port's weight: the HWIO kernel as OIHW
        conv.weight.copy_(t(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(t(bias))
    tx = t(x).requires_grad_()
    out = tvit.conv_transpose2x(conv, tx)
    assert np.abs(out.detach().numpy() - np.asarray(want_out)).max() <= 1e-5 * np.abs(np.asarray(want_out)).max()
    (out * t(cot)).sum().backward()
    for g, w in ((tx.grad, want[0]), (conv.weight.grad.permute(2, 3, 1, 0), want[1]), (conv.bias.grad, want[2])):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
