"""Training MiT (B0, the smallest preset of the MiT-B3/B4/B5 recipes' family) under the
narrow head: the port against rba_tpu on the CPU at fp32 (``tests/test_torch_train_backbones.py``
has the setting).  Each weighted loss within 1e-4, every gradient within 1e-4 relative to
its leaf's largest magnitude: the spatial-reduction attention, the depthwise MLP conv
and the LayerNorms with their variance centred.  ``drop_path_rate`` is not applied, as in
rba_tpu (ROADMAP.md §C.5).
"""
import pytest

from tests.torch_port_common import TrainStepPair, assert_gradients_match, assert_losses_match, record


@pytest.fixture(scope="module")
def mit_b0():
    return TrainStepPair("mit_b0")


def test_losses_match_rba_tpu(mit_b0, request):
    record(request, loss_rel_err=assert_losses_match(mit_b0))


def test_gradients_match_rba_tpu(mit_b0, request):
    grads = assert_gradients_match(mit_b0, request)
    assert any(n.endswith("attn.sr.weight") for n in grads) and any(n.endswith("mlp.dwconv.weight") for n in grads)
