"""The port's test-time augmentation against rba_tpu's on the CPU at fp32.

``tiny_test_config`` with seeded weights (``d2_model_pair``); two images of odd sizes
that are not multiples of the size divisibility, 24×35 with ``min_sizes=(32, 48)`` and
23×37 with ``min_sizes=(32, 46)``, both with flip, where each second scale is exactly
twice the shortest edge (the exact 2× resize branch).
Bound on the averaged sem_seg: ``SEM_TOL``, the fp32 bound of the port's
``maskformer_infer`` against rba_tpu's (tests/test_torch_maskformer.py).  rba_tpu's
``tta_inference`` jits each variant, as it serves.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models import tta as jtta
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import tta as ttta
from rba_tpu_torch.ops import resize as tresize
from tests.torch_port_common import d2_model_pair, max_abs

SEM_TOL = 1e-4
# (image size, min_sizes): each second scale is twice the shortest edge, an exact 2x
CASES = (((24, 35), (32, 48)), ((23, 37), (32, 46)))


@pytest.fixture(scope="module")
def tiny():
    return d2_model_pair(jconfig.tiny_test_config(), tconfig.tiny_test_config(), seed=0)


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(5)
    return [(rs.rand(h, w, 3) * 255).astype(np.uint8) for (h, w), _ in CASES]


@pytest.fixture(scope="module")
def want(tiny, images):
    """rba_tpu's averaged sem_seg of each image."""
    params, _ = tiny
    return [np.asarray(jtta.tta_inference(params, jconfig.tiny_test_config(), img, min_sizes=min_sizes, flip=True))
            for img, (_, min_sizes) in zip(images, CASES)]


def test_resize_shortest_edge_size_matches_rba_tpu():
    for h, w in ((24, 35), (27, 41), (1024, 2048), (3072, 4096), (100, 100), (7, 1000)):
        for size in (32, 48, 512, 1024, 1792):
            for max_size in (64, 1333, 4096):
                got = ttta.resize_shortest_edge_size(h, w, size, max_size)
                assert got == jtta.resize_shortest_edge_size(h, w, size, max_size), (h, w, size, max_size)
    assert ttta.resize_shortest_edge_size(1024, 2048, 1792, 4096) == (1792, 3584)
    assert ttta.resize_shortest_edge_size(1024, 2048, 1792, 3000) == (1500, 3000)  # the max_size cap
    assert ttta.resize_shortest_edge_size(24, 35, 32, 4096) == (32, 47)  # int(46.67 + 0.5)


def test_variants_take_the_exact_2x_branch():
    cfg = tconfig.tiny_test_config()
    assert ttta.tta_variants(cfg, *CASES[0][0], CASES[0][1], True) == [
        (32, 47, False), (32, 47, True), (48, 70, False), (48, 70, True)]
    assert ttta.tta_variants(cfg, *CASES[1][0], CASES[1][1], True) == [
        (32, 51, False), (32, 51, True), (46, 74, False), (46, 74, True)]
    for (h, w), _ in CASES:
        x = torch.rand(1, h, w, 3) * 255
        assert torch.equal(tresize.resize_bilinear_nhwc(x, (2 * h, 2 * w)), tresize.upsample2x_bilinear_nhwc(x))


@pytest.mark.parametrize("attention", ["fused", "fused_softmax", "xla"])
def test_tta_matches_rba_tpu(tiny, images, want, attention):
    _, model = tiny
    cfg = tconfig.tiny_test_config()
    if attention == "fused_softmax":  # path 2: Kernel C's plain version, with Kernel D's
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, mlp_impl="fused"))
    for img, w, (_, min_sizes) in zip(images, want, CASES):
        got = ttta.tta_inference(model, cfg, img, min_sizes=min_sizes, flip=True, attention=attention)
        assert got.shape == (7, *img.shape[:2])
        assert max_abs(got, w) < SEM_TOL


def test_config_defaults_are_test_aug(tiny, images):
    """Without min_sizes and flip the config's TEST.AUG fields decide."""
    _, model = tiny
    cfg = dataclasses.replace(tconfig.tiny_test_config(), test=dataclasses.replace(
        tconfig.tiny_test_config().test, aug_min_sizes=(32,), aug_flip=False))
    got = ttta.tta_inference(model, cfg, images[1])
    assert torch.equal(got, ttta.tta_inference(model, cfg, images[1], min_sizes=(32,), flip=False))
    assert not torch.equal(got, ttta.tta_inference(model, cfg, images[1], min_sizes=(32,), flip=True))


def test_one_scale_at_the_image_size_without_flip_equals_maskformer_infer(tiny, images):
    _, model = tiny
    cfg = tconfig.tiny_test_config()
    for img in images + [np.ascontiguousarray(images[0][:, :27])]:
        got = ttta.tta_inference(model, cfg, img, min_sizes=(min(img.shape[:2]),), flip=False)
        want = tmf.maskformer_infer(model, cfg, torch.as_tensor(img).float()[None])["sem_seg"][0]
        assert torch.equal(got, want)
