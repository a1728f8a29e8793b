"""Training ViT with the SimpleFeaturePyramid (``vit_sfp``: res2–res5 at strides 4–32 from
2x2 transposed convs and a max pool): the port against rba_tpu on the CPU at fp32
(``tests/test_torch_train_backbones.py`` has the setting).  Each weighted loss within
1e-4, every gradient within 1e-4 relative to its leaf's largest magnitude, the pyramid's
flipped conv-transpose kernels included.  rba_tpu's own jitted step cannot take the SFP
tree, whose scale factors are Python numbers (ROADMAP.md §C.14); the reference gradient
closes over them.
"""
import numpy as np
import pytest

from tests.torch_port_common import TrainStepPair, assert_gradients_match, assert_losses_match, record


@pytest.fixture(scope="module")
def vit_sfp():
    return TrainStepPair("vit_sfp")


def test_losses_match_rba_tpu(vit_sfp, request):
    assert vit_sfp.model.mask_stride(vit_sfp.tcfg) == 4
    record(request, loss_rel_err=assert_losses_match(vit_sfp))


def test_gradients_match_rba_tpu(vit_sfp, request):
    grads = assert_gradients_match(vit_sfp, request)
    # the scale-4 stage's two transposed convs and the scale-2 stage's one
    for name in ("vit.pos_embed", "vit.blocks.0.attn.rel_pos_h", "sfp.stages.0.up1.weight", "sfp.stages.0.up2.weight",
                 "sfp.stages.1.up1.weight"):
        assert np.abs(grads["backbone." + name]).max() > 0, name
