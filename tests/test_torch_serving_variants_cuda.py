"""The serving variants on the card: test-time augmentation, sliding-window inference and
the DenseHybrid score through the kernels, against the same functions through the
kernels' plain versions (``plain_versions()``), on one model on the card.

Marked ``cuda``: each test skips where no CUDA GPU is present (there
tests/test_torch_tta.py, tests/test_torch_sliding_window.py and
tests/test_torch_dense_hybrid.py hold the same functions against rba_tpu).  On a
machine with an H100: ``python -m pytest tests/test_torch_serving_variants_cuda.py -q
--noconftest``.  ``tiny_test_config`` at fp32; bound ``FP32_TOL``, the score-map bound
of rba_tpu's selfcheck.  TF32 is off.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rba_tpu_torch import config as tconfig
from rba_tpu_torch.evalx import evaluator as tev
from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.kernels.fused_mlp import fused_mlp_residual
from rba_tpu_torch.kernels.masked_softmax import masked_softmax
from rba_tpu_torch.kernels.window_attention import window_attention
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import sliding_window as tsw
from rba_tpu_torch.models import tta as ttta

pytestmark = pytest.mark.cuda

FP32_TOL = 1e-3
N_BLOCKS = sum(tconfig.tiny_test_config().swin.depths)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _counting(*wrappers):
    for fn in wrappers:
        fn.launches = 0
    return lambda: [fn.launches for fn in wrappers]


@pytest.mark.parametrize("attention", ["fused", "fused_softmax"])
def test_tta_kernels_match_plain(cuda, attention):
    cfg = tconfig.tiny_test_config()
    if attention == "fused_softmax":
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, mlp_impl="fused"))
    model = tmf.build_model(cfg, device=cuda, seed=0)
    img = _image(70, 101, 0)
    kernel = window_attention if attention == "fused" else masked_softmax
    launches = _counting(kernel)
    got = ttta.tta_inference(model, cfg, img, min_sizes=(64, 140), flip=True, attention=attention)
    assert launches() == [4 * N_BLOCKS]  # 2 scales x 2 flips, every block
    with plain_versions():
        want = ttta.tta_inference(model, cfg, img, min_sizes=(64, 140), flip=True, attention=attention)
    assert got.shape == (7, 70, 101) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= FP32_TOL


def test_sliding_window_kernels_match_plain(cuda):
    cfg = tconfig.tiny_test_config()
    model = tmf.build_model(cfg, device=cuda, seed=1)
    img = _image(100, 150, 1)
    launches = _counting(window_attention, fused_mlp_residual)
    got = tsw.sliding_window_sem_seg(model, cfg, img, tile_hw=(64, 64), overlap=16)
    _, _, _, ys, xs = tsw.tile_grid(100, 150, (64, 64), 16)
    assert launches() == [len(ys) * len(xs) * N_BLOCKS, 0]
    with plain_versions():
        want = tsw.sliding_window_sem_seg(model, cfg, img, tile_hw=(64, 64), overlap=16)
    assert got.shape == (7, 100, 150) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= FP32_TOL


def test_dense_hybrid_score_kernels_match_plain(cuda):
    cfg = tconfig.tiny_test_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, ood_prediction=True))
    model = tmf.build_model(cfg, device=cuda, seed=2)
    img = _image(96, 130, 2)[None]
    got = tev.make_score_fn(cfg, model, "dense_hybrid")(img)
    x = torch.as_tensor(img, device=cuda).float()
    with plain_versions():
        out = tmf.maskformer_infer(model, cfg, x)
    want = -torch.logsumexp(out["sem_seg"], 1) + torch.log(torch.softmax(out["ood_pred"], 1)[:, 1] + 1e-9)
    assert got.shape == (1, 96, 130) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= FP32_TOL
