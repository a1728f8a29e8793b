"""The port's ``evalx/support.py`` helpers against rba_tpu's on the CPU at fp32.

The model helpers run ``tiny_test_config`` with seeded weights (``d2_model_pair``) on
one 40×56 image; rba_tpu's four are jitted together, one compile.  Bounds: ``TOL`` on
logits and probabilities, the fp32 bound of the port's ``maskformer_infer`` against
rba_tpu's (tests/test_torch_maskformer.py), scaled by the K = 7 terms of the sums;
1e-6 on the elementwise helpers.
"""
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.evalx import support as jsup
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.evalx import support as tsup
from tests.torch_port_common import d2_model_pair, max_abs, t

matplotlib.use("Agg")

TOL = 1e-4
SUM_TOL = 7 * TOL


@pytest.fixture(scope="module")
def tiny():
    return d2_model_pair(jconfig.tiny_test_config(), tconfig.tiny_test_config(), seed=2)


@pytest.fixture(scope="module")
def image():
    return (np.random.RandomState(8).rand(1, 40, 56, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def want(tiny, image):
    params, _ = tiny
    cfg = jconfig.tiny_test_config()

    def helpers(p, x):
        logits_aux, aux = jsup.get_logits_plus(p, cfg, x, return_aux=True)
        return (jsup.get_logits(p, cfg, x), jsup.get_logits_plus(p, cfg, x), logits_aux, aux,
                jsup.get_neg_logit_sum(p, cfg, x), jsup.get_RbA(p, cfg, x))

    return jax.jit(helpers)(params, jnp.asarray(image))


def test_model_helpers_match_rba_tpu(tiny, image, want):
    _, model = tiny
    cfg = tconfig.tiny_test_config()
    logits, plus, logits_aux, aux, neg_sum, rba = want
    assert max_abs(tsup.get_logits(model, cfg, image), logits) < TOL
    assert max_abs(tsup.get_logits_plus(model, cfg, image), plus) < TOL
    got_logits, got_aux = tsup.get_logits_plus(model, cfg, image, return_aux=True)
    assert max_abs(got_logits, logits_aux) < TOL
    assert sorted(got_aux) == sorted(aux) == ["rba"]
    assert max_abs(got_aux["rba"], aux["rba"]) < SUM_TOL
    assert max_abs(tsup.get_neg_logit_sum(model, cfg, image), neg_sum) < SUM_TOL
    assert max_abs(tsup.get_RbA(model, cfg, image), rba) < SUM_TOL
    assert max_abs(tsup.get_RbA(model, cfg, image, attention="xla"), rba) < SUM_TOL


def test_elementwise_helpers_match_rba_tpu(rng):
    x = (rng.randn(5, 6) * 4).astype(np.float32)
    for kw in ({}, dict(k=2.5, x0=0.3, L=3.0)):
        assert max_abs(tsup.logistic(t(x), **kw), jsup.logistic(jnp.asarray(x), **kw)) < 1e-6
    m = rng.rand(2, 13, 17).astype(np.float32)
    for shape in ((26, 34), (7, 9), np.array([20, 5])):
        assert max_abs(tsup.resize_mask(t(m), shape), jsup.resize_mask(jnp.asarray(m), shape)) < 1e-6


def test_image_helpers_equal_rba_tpu(rng):
    chw = rng.rand(3, 8, 10).astype(np.float32)
    for img in (chw, chw.transpose(1, 2, 0), rng.rand(8, 10).astype(np.float32)):
        np.testing.assert_array_equal(tsup.proc_img(torch.from_numpy(img)), jsup.proc_img(img))
    preds = rng.randint(0, 4, (9, 11))
    colors = [(128, 64, 128), (244, 35, 232), (70, 70, 70)]  # class 3 has no color: stays black
    np.testing.assert_array_equal(tsup.get_seg_colormap(torch.from_numpy(preds), colors),
                                  jsup.get_seg_colormap(preds, colors))


def test_show_helpers_draw(rng):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    try:
        tsup.show_mask(rng.rand(9, 11) > 0.5, ax)
        tsup.show_mask(rng.rand(9, 11) > 0.5, ax, random_color=True)
        tsup.show_points(np.array([[1, 2], [3, 4]]), np.array([1, 0]), ax)
        tsup.show_box([1, 1, 5, 6], ax)
        tsup.show_anns([{"segmentation": rng.rand(9, 11) > 0.5, "area": 3}])
        tsup.show_anns([])
        assert len(ax.images) == 3 and len(ax.collections) == 2 and len(ax.patches) == 1
    finally:
        plt.close(fig)
