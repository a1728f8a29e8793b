"""The port's sliding-window inference against rba_tpu's on the CPU at fp32.

``tiny_test_config`` with seeded weights (``d2_model_pair``), a 48×80 image cut into
32×32 tiles with overlap 8: two rows and three columns of tiles, the last of each
flush with the edge.  Bound on the blended sem_seg and its RbA score: ``SEM_TOL``,
the fp32 bound of the port's ``maskformer_infer`` against rba_tpu's
(tests/test_torch_maskformer.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models import sliding_window as jsw
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import sliding_window as tsw
from tests.torch_port_common import d2_model_pair, max_abs

SEM_TOL = 1e-4
TILE, OVERLAP = (32, 32), 8


@pytest.fixture(scope="module")
def tiny():
    return d2_model_pair(jconfig.tiny_test_config(), tconfig.tiny_test_config(), seed=1)


@pytest.fixture(scope="module")
def image():
    return (np.random.RandomState(6).rand(48, 80, 3) * 255).astype(np.uint8)


def test_feather_weight_equals_rba_tpu():
    for th, tw, overlap in ((32, 32, 8), (1024, 1024, 256), (48, 17, 8), (5, 9, 0)):
        got, want = tsw._feather_weight(th, tw, overlap), jsw._feather_weight(th, tw, overlap)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _rba_tpu_tiles(monkeypatch, h, w, tile_hw, overlap):
    """The (y, x) of each tile rba_tpu infers, read from an image whose pixels hold
    their own coordinates (one class, so that the blend stays small)."""
    seen = []

    def fake_infer_fn(cfg):
        def infer(params, tile):
            seen.append((int(tile[0, 0, 0, 0]), int(tile[0, 0, 0, 1])))
            return jnp.zeros((cfg.num_classes, tile.shape[1], tile.shape[2]), jnp.float32)
        return infer

    monkeypatch.setattr(jsw, "_tile_infer_fn", fake_infer_fn)
    yx = np.stack([*np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), np.zeros((h, w), int)], -1)
    jsw.sliding_window_sem_seg(None, jconfig.tiny_test_config(num_classes=1), yx.astype(np.float32), tile_hw, overlap)
    return seen


@pytest.mark.parametrize("h, w, tile_hw, overlap", [
    (48, 80, TILE, OVERLAP), (1024, 2048, (1024, 1024), 256), (3072, 4096, (1024, 1024), 256),
    (700, 1500, (1024, 1024), 256), (40, 100, (32, 48), 30),
])
def test_tile_positions_equal_rba_tpus(monkeypatch, h, w, tile_hw, overlap):
    _, _, _, ys, xs = tsw.tile_grid(h, w, tile_hw, overlap)
    assert [(y, x) for y in ys for x in xs] == _rba_tpu_tiles(monkeypatch, h, w, tile_hw, overlap)


def test_tile_grid_of_the_served_sizes():
    assert tsw.tile_grid(1024, 2048)[3:] == ([0], [0, 768, 1024])  # the last tile flush with the edge
    assert tsw.tile_grid(3072, 4096)[3:] == ([0, 768, 1536, 2048], [0, 768, 1536, 2304, 3072])
    assert tsw.tile_grid(48, 80, TILE, OVERLAP)[3:] == ([0, 16], [0, 24, 48])


def test_sem_seg_and_rba_match_rba_tpu(tiny, image):
    params, model = tiny
    want = jsw.sliding_window_sem_seg(params, jconfig.tiny_test_config(), image, TILE, OVERLAP)
    got = tsw.sliding_window_sem_seg(model, tconfig.tiny_test_config(), image, TILE, OVERLAP)
    assert got.shape == (7, 48, 80)
    assert max_abs(got, want) < SEM_TOL
    rba = tsw.sliding_window_rba(model, tconfig.tiny_test_config(), image, tile_hw=TILE, overlap=OVERLAP)
    want_rba = jsw.sliding_window_rba(params, jconfig.tiny_test_config(), image, tile_hw=TILE, overlap=OVERLAP)
    assert rba.shape == (48, 80)
    assert max_abs(rba, want_rba) < SEM_TOL


def test_single_tile_equals_maskformer_infer(tiny, image):
    """An image no larger than a tile is one tile, whose weight divides out: sem·w / w,
    one fp32 rounding from the unblended map (bound 1e-6 on probabilities in [0, 1])."""
    _, model = tiny
    cfg = tconfig.tiny_test_config()
    small = image[:30, :31]
    got = tsw.sliding_window_sem_seg(model, cfg, small)
    want = tmf.maskformer_infer(model, cfg, torch.as_tensor(small).float()[None])["sem_seg"][0]
    assert max_abs(got, want) < 1e-6
