"""2D sine position embedding, DETR style (counterpart of ``rba_tpu/models/position_encoding.py``).

With an all-valid mask the cumulative sums of the reference reduce to row and
column index + 1, so the embedding is a closed form, computed in numpy once per
shape and copied to a device once per shape, dtype and device (a stride-8 level of a
1024×2048 frame is 33.5 MB of fp32 that would otherwise cross from pageable host memory
on every request).  Layout (H, W, C): channels [pos_y | pos_x], each half interleaved as
(sin, cos) pairs per frequency.  Callers must not write into the returned tensor.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _sine_pos_embed_np(h: int, w: int, num_pos_feats: int, temperature: float = 10000.0) -> np.ndarray:
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None, :]
    y_embed = y_embed / (h + eps) * scale
    x_embed = x_embed / (w + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=2)


@functools.lru_cache(maxsize=16)
def _sine_pos_embed_on(h: int, w: int, channels: int, dtype, device) -> torch.Tensor:
    with torch.inference_mode(False):  # the cached tensor also serves calls that track gradients
        return torch.as_tensor(_sine_pos_embed_np(h, w, channels // 2), dtype=dtype, device=device)


def sine_pos_embed(h: int, w: int, channels: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, channels) sine embedding; ``channels`` must be even."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    return _sine_pos_embed_on(h, w, channels, dtype, torch.device(device) if device is not None else None)
