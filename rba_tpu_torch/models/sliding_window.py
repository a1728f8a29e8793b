"""Sliding-window inference for very high resolution images (counterpart of
``rba_tpu/models/sliding_window.py``).

The model runs on overlapping fixed-size tiles and the class-probability maps are
blended with a linear feathering window: the weight ramps across each overlap
margin, so every pixel's sum of weights is positive.  Tiles step by tile − overlap;
the last tile of a row or column sits flush with the image's edge.  The blend
(``total``, ``norm``) stays on the model's device.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..config import RbAConfig
from .maskformer import maskformer_infer, rba_score


@functools.lru_cache(maxsize=16)
def _feather_weight(th: int, tw: int, overlap: int) -> np.ndarray:
    """(th, tw) blending weight: a linear ramp across the overlap margins."""
    def ramp(n, size):
        w = np.ones(size, np.float32)
        if n > 0:
            r = (np.arange(n) + 1) / (n + 1)
            w[:n] = r
            w[size - n :] = r[::-1]
        return w

    return np.outer(ramp(overlap, th), ramp(overlap, tw))


def tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Start of each tile along an axis of ``size``: every ``stride``, and a last tile
    flush with the edge where the steps fall short of it."""
    starts = list(range(0, max(size - tile, 0) + 1, stride))
    if starts[-1] + tile < size:
        starts.append(size - tile)
    return starts


def tile_grid(h: int, w: int, tile_hw: Tuple[int, int] = (1024, 1024), overlap: int = 256):
    """(tile height, tile width, overlap, row starts, column starts) of an h×w image: the
    tile cut to the image and the overlap to half the tile."""
    th, tw = min(tile_hw[0], h), min(tile_hw[1], w)
    overlap = min(overlap, th // 2, tw // 2)
    return th, tw, overlap, tile_starts(h, th, max(th - overlap, 1)), tile_starts(w, tw, max(tw - overlap, 1))


@torch.inference_mode()
def sliding_window_sem_seg(
    model,
    cfg: RbAConfig,
    image,  # (H, W, 3) raw RGB, numpy or tensor, arbitrarily large
    tile_hw: Tuple[int, int] = (1024, 1024),
    overlap: int = 256,
    attention: str = "fused",
) -> torch.Tensor:  # (K, H, W) fp32 on the model's device
    """Weighted blend of the class probabilities of overlapping tiles, each through Swin's
    ``attention`` branch."""
    h, w = image.shape[:2]
    th, tw, overlap, ys, xs = tile_grid(h, w, tile_hw, overlap)
    device = next(model.parameters()).device
    weight = torch.as_tensor(_feather_weight(th, tw, overlap), device=device)
    total = torch.zeros(cfg.num_classes, h, w, dtype=torch.float32, device=device)
    norm = torch.zeros(h, w, dtype=torch.float32, device=device)
    img = torch.as_tensor(image).to(device).float()
    for y in ys:
        for x in xs:
            tile = img[None, y : y + th, x : x + tw]
            sem = maskformer_infer(model, cfg, tile, attention=attention)["sem_seg"][0]
            total[:, y : y + th, x : x + tw] += sem * weight[None]
            norm[y : y + th, x : x + tw] += weight
    return total / torch.clamp(norm, min=1e-6)[None]


def sliding_window_rba(model, cfg: RbAConfig, image, **kw) -> torch.Tensor:
    """(H, W) RbA score of the blended probability map."""
    sem = sliding_window_sem_seg(model, cfg, image, **kw)
    return rba_score(sem[None])[0]
