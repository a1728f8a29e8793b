"""``load_jax_params`` carries rba_tpu's MaskFormer pytree into the port's model: every
leaf in the torch layout, and an error on any missing, unexpected or misshapen leaf."""
import jax
import numpy as np
import pytest
import torch

from rba_tpu.config import tiny_test_config as j_tiny
from rba_tpu.models.maskformer import maskformer_init
from rba_tpu_torch.config import tiny_test_config
from rba_tpu_torch.convert import load_jax_params
from rba_tpu_torch.models.maskformer import build_model
from tests.torch_port_common import perturbed


@pytest.fixture(scope="module")
def params():
    return perturbed(maskformer_init(jax.random.PRNGKey(0), j_tiny()), seed=1)


def _copy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def test_every_leaf_lands_in_the_torch_layout(params):
    model = load_jax_params(build_model(tiny_test_config(), device="cpu"), params)
    sd = model.state_dict()
    qkv = params["backbone"]["layers"][0]["blocks"][1]["attn"]["qkv"]
    np.testing.assert_array_equal(sd["backbone.layers.0.blocks.1.attn.qkv.weight"].numpy(), qkv["kernel"].T)
    np.testing.assert_array_equal(sd["backbone.layers.0.blocks.1.attn.qkv.bias"].numpy(), qkv["bias"])
    conv = params["sem_seg_head"]["pixel_decoder"]["fpn"][0]["output"]["conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["sem_seg_head.pixel_decoder.fpn.0.output.conv.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    norm = params["backbone"]["norm0"]
    np.testing.assert_array_equal(sd["backbone.norm0.weight"].numpy(), norm["scale"])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(list(model.parameters()))


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_faults_raise(params, fault):
    tree = _copy(params)
    cls = tree["sem_seg_head"]["predictor"]["class_embed"]
    if fault == "missing":
        del cls["bias"]
    elif fault == "unexpected":
        cls["extra"] = np.zeros(3, np.float32)
    else:
        cls["bias"] = np.zeros(cls["bias"].shape[0] + 1, np.float32)
    model = build_model(tiny_test_config(), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_jax_params(model, tree)
    if fault != "shape":  # names are checked before anything is copied
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
