"""Point sampling of mask logits for the matcher and the mask losses (counterpart of
``rba_tpu/ops/point_sample.py``).

``point_sample`` is one bilinear sample with ``grid_sample(align_corners=False,
padding_mode="zeros")`` semantics, written as four corner gathers; ``rba_tpu``'s four
lowerings of it are TPU layout choices.  ``uncertain_point_coords`` is the importance
sampling of the mask loss: oversample uniformly, keep the most uncertain points
(``-|logit|`` largest, ties to the lower index as ``jax.lax.top_k`` breaks them), fill
the rest with fresh uniform points.

Every random number of the training criterion is drawn through one ``Uniform``: a
function of a shape that returns that many U[0, 1) fp32 numbers.  ``uniform_from``
makes it from a ``torch.Generator``; a test can hand in ``rba_tpu``'s ``jax.random``
draws instead, in the order the criterion asks for them.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

Uniform = Callable[[Tuple[int, ...]], torch.Tensor]


def uniform_from(gen: torch.Generator, shard: Tuple[int, int] = (0, 1)) -> Uniform:
    """U[0, 1) fp32 draws of a given shape from ``gen``, on ``gen``'s device.

    ``shard`` = (data rank, data ranks): every draw's dim 0 runs over this rank's rows of
    the batch, so the draw is made at the global batch's shape (dim 0 times the ranks),
    from a generator that every rank seeds alike, and the rank takes its rows.  The
    points then do not depend on the number of ranks."""
    rank, size = shard
    if size == 1:
        return lambda shape: torch.rand(shape, generator=gen, device=gen.device)

    def draw(shape):
        n = shape[0]
        return torch.rand((n * size, *shape[1:]), generator=gen, device=gen.device)[rank * n : (rank + 1) * n]

    return draw


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(B, Q, H, W) mask logits sampled at (B, P, 2) normalized (x, y) coords in [0, 1]:
    (B, Q, P), zero outside the map.  The pixel coordinate is ``coords · (W, H) − 0.5``,
    taken as ``rba_tpu`` takes it (``grid_sample`` rounds ``((2c − 1 + 1)·W − 1) / 2``
    instead, up to 1e-5 off at W = 260); four corner gathers and the weighted sum."""
    b, q, h, w = masks.shape
    x = coords[..., 0] * w - 0.5  # (B, P)
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[:, None, :], (y - y0)[:, None, :]
    x0i, y0i = x0.long(), y0.long()
    flat = masks.reshape(b, q, h * w)

    def corner(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(flat, 2, idx[:, None, :].expand(-1, q, -1))
        return torch.where(valid[:, None, :], v, torch.zeros((), dtype=v.dtype, device=v.device))

    return (corner(y0i, x0i) * (1 - tx) * (1 - ty) + corner(y0i, x0i + 1) * tx * (1 - ty)
            + corner(y0i + 1, x0i) * (1 - tx) * ty + corner(y0i + 1, x0i + 1) * tx * ty)


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of (B, N), largest first, equal
    values in index order: ``jax.lax.top_k``'s choice (``torch.topk`` leaves ties open)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[:, :k]


def uncertain_point_coords(
    uniform: Uniform,
    mask_logits: torch.Tensor,  # (B, Q, H, W): the matched predictions' logits
    num_points: int,
    oversample_ratio: float,
    importance_sample_ratio: float,
) -> torch.Tensor:  # (B, num_points, 2)
    """Two draws, in this order: (B, num_points · oversample_ratio, 2) uniform points, and,
    when some are left to fill, (B, n_random, 2) more."""
    b = mask_logits.shape[0]
    n_sampled = int(num_points * oversample_ratio)
    coords = uniform((b, n_sampled, 2))
    uncertainty = -point_sample(mask_logits, coords)[:, 0].abs()  # channel 0, as Detectron2 takes it
    n_uncertain = int(importance_sample_ratio * num_points)
    n_random = num_points - n_uncertain
    idx = top_k_indices(uncertainty, n_uncertain)
    chosen = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
    if n_random > 0:
        chosen = torch.cat([chosen, uniform((b, n_random, 2))], dim=1)
    return chosen
