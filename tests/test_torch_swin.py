"""The port's Swin backbone against rba_tpu.models.swin at fp32 on the CPU (atol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.config import tiny_test_config as j_tiny
from rba_tpu.models import swin as jswin
from rba_tpu_torch.config import tiny_test_config
from rba_tpu_torch.convert import load_jax_params
from rba_tpu_torch.models import swin as tswin
from tests.torch_port_common import max_abs, perturbed, t, to_jax

ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny_swin():
    params = perturbed(jswin.swin_init(jax.random.PRNGKey(0), j_tiny().swin), seed=1)
    model = tswin.Swin(tiny_test_config().swin)
    load_jax_params(model, params)
    return params, model


# (36, 52) is not a multiple of the stride-4 window grid, so every stage pads;
# batch 2 checks that windows of different images stay apart
@pytest.mark.parametrize("bhw", [(2, 36, 52), (1, 64, 64)], ids=["pad_b2", "even_b1"])
def test_swin_apply_matches(tiny_swin, rng, bhw):
    params, model = tiny_swin
    cfg = tiny_test_config().swin
    images = rng.randn(*bhw, 3).astype(np.float32)
    want = jswin.swin_apply(to_jax(params), j_tiny().swin, jnp.asarray(images), compute_dtype=jnp.float32)
    with torch.no_grad():
        got = tswin.swin_apply(model, cfg, t(images), compute_dtype=torch.float32)
    assert sorted(got) == sorted(want) == ["res2", "res3"]
    for name in got:
        assert max_abs(got[name], want[name]) < ATOL, name


@pytest.mark.parametrize("shift", [0, 2])
def test_block_matches(tiny_swin, rng, shift):
    """One block on a (1, 9, 13) map: padded to the 4-window grid, shifted or not."""
    params, model = tiny_swin
    x = rng.randn(1, 9, 13, 32).astype(np.float32)
    want = jswin.swin_block_apply(to_jax(params["layers"][0]["blocks"][1]), jnp.asarray(x), num_heads=2, ws=4,
                                  shift=shift, qk_scale=None)
    with torch.no_grad():
        got = tswin.swin_block_apply(model.layers[0].blocks[1], t(x), 2, 4, shift, None)
    assert max_abs(got, want) < ATOL


def test_patch_merging_odd_size(tiny_swin, rng):
    params, model = tiny_swin
    x = rng.randn(2, 7, 9, 32).astype(np.float32)
    want = jswin._patch_merging(to_jax(params["layers"][0]["downsample"]), jnp.asarray(x))
    with torch.no_grad():
        got = tswin._patch_merging(model.layers[0].downsample, t(x))
    assert got.shape == (2, 4, 5, 64)
    assert max_abs(got, want) < ATOL


def test_plain_flag_is_the_same_function_on_cpu(tiny_swin, rng):
    _, model = tiny_swin
    x = t(rng.randn(1, 32, 32, 3))
    cfg = tiny_test_config().swin
    with torch.no_grad():
        a = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32)
        b = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32, plain=True)
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)


def test_cached_constants_serve_inference_and_grad_mode(tiny_swin, rng):
    """The window constants cached by a call under inference_mode also serve a later
    call that tracks gradients (the model's parameters require grad)."""
    _, model = tiny_swin
    x = t(rng.randn(1, 36, 44, 3))  # a shape no other test of this file uses
    cfg = tiny_test_config().swin
    with torch.inference_mode():
        a = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32)
    b = tswin.swin_apply(model, cfg, x, compute_dtype=torch.float32)
    for name in a:
        assert b[name].requires_grad
        torch.testing.assert_close(a[name], b[name].detach(), rtol=0, atol=0)
