"""Inputs made from the run's seed: the model's weights, the camera frames and the
evaluation scenes with their labels.

Everything is drawn on the run's device with a ``torch.Generator`` seeded from
(seed, purpose), in a few large calls, so one seed gives the same bytes on one device
and another seed gives others.  The weights and the frames are handed to the program
and to the reference alike.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

# the sampling offsets' weights are drawn at OFFSET_GAIN / sqrt(fan_in) (see ``weight_rule``)
OFFSET_GAIN = 2.0


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of one run, from any whole number ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, purpose))


def offset_grid(heads: int, levels: int, points: int) -> torch.Tensor:
    """Deformable DETR's directional sampling-offset bias: head h points along angle
    2πh/heads, its p-th point p + 1 pixels out, on every level."""
    theta = torch.arange(heads, dtype=torch.float64) * (2 * math.pi / heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float64)[None, None, :, None]
    return grid.reshape(-1).float()


def weight_rule(name: str, shape: Tuple[int, ...], model: dict) -> Tuple[float, object]:
    """(scale, shift) of the parameter ``name``: value = scale · N(0, 1) + shift.

    Matrices and convolution kernels: 1/sqrt(fan_in), and the sampling offsets'
    OFFSET_GAIN/sqrt(fan_in), which spreads a query's points over several pixels of
    each level.  The offsets' bias is the directional grid, with no noise.  Norm
    scales and batch-norm variances 1 ± 0.1, biases and batch-norm means 0.02 and 0.1,
    the Swin relative-position tables 0.02, the queries' and levels' embeddings 1."""
    if name.endswith("sampling_offsets.bias"):
        pd = model["pixel_decoder"]
        return 0.0, offset_grid(pd["transformer_nheads"], len(pd["transformer_in_features"]), pd["enc_n_points"])
    if name.endswith("relative_position_bias_table"):
        return 0.02, 0.0
    if name.endswith(("query_feat", "query_embed", "level_embed")):
        return 1.0, 0.0
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        gain = OFFSET_GAIN if name.endswith("sampling_offsets.weight") else 1.0
        return gain / math.sqrt(fan_in), 0.0
    if name.endswith((".weight", ".var")):
        return 0.1, 1.0
    if name.endswith(".mean"):
        return 0.1, 0.0
    return 0.02, 0.0


def make_weights(shapes: Dict[str, Tuple[int, ...]], model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 weights by parameter name, from one draw of N(0, 1) on ``device``."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, start = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, shift = weight_rule(name, tuple(shape), model)
        shift = shift.to(device) if isinstance(shift, torch.Tensor) else shift
        out[name] = flat[start:start + n].view(shape).mul_(scale).add_(shift)
        start += n
    return out


def _uniform(g, n: int, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def _randint(g, n: int, lo, hi, device) -> torch.Tensor:
    """Integers in [lo, hi) per frame; ``lo`` and ``hi`` may be tensors."""
    return (lo + torch.rand(n, generator=g, device=device) * (hi - lo)).floor()


def make_scenes(n: int, h: int, w: int, scene: dict, seed: int, device, chunk: int = 8
                ) -> Iterable[Tuple[torch.Tensor, torch.Tensor]]:
    """Structured road-like scenes, ``chunk`` frames at a time: ((k, h, w, 3) uint8
    images, (k, h, w) uint8 labels: 0 inlier, 1 anomaly, 255 void).

    Each frame: a sky-to-ground gradient, low-frequency terrain, a colour cast,
    ``scene["stripes"]`` bands of stripes, ``scene["inliers"]`` objects in the scene's
    palette, ``scene["anomalies"]`` saturated, textured objects labelled 1, sensor noise,
    and a 2-pixel void strip at the top.  Every seed draws the same number of each."""
    g = generator(seed, "scenes", device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    for first in range(0, n, chunk):
        k = min(chunk, n - first)
        terrain = F.interpolate(torch.randn(k, 1, 8, 16, generator=g, device=device) * 25, size=(h, w),
                                mode="bilinear", align_corners=True)[:, 0]
        img = (90 + 70 * (1 - yy / h) + terrain)[..., None] + torch.randn(k, 1, 1, 3, generator=g, device=device) * 10
        img = img.expand(k, h, w, 3).clone()
        for _ in range(scene["stripes"]):
            ys = torch.sort(_randint(g, 2 * k, 0, h, device).view(k, 2), dim=1).values
            pitch = _randint(g, k, 8, 64, device)[:, None, None]
            diagonal = (torch.rand(k, generator=g, device=device) < 0.5)[:, None, None]
            phase = torch.where(diagonal, xx + yy, xx.expand(k, 1, w))
            band = (yy >= ys[:, 0, None, None]) & (yy < ys[:, 1, None, None])
            stripe = band & (torch.sin(2 * math.pi * phase / pitch) > 0)
            img += stripe[..., None] * _uniform(g, k, 8, 25, device)[:, None, None, None]
        label = torch.zeros(k, h, w, dtype=torch.uint8, device=device)
        for anomaly in [False] * scene["inliers"] + [True] * scene["anomalies"]:
            if anomaly:
                cy, cx = _randint(g, k, h // 8, h - h // 8, device), _randint(g, k, w // 8, w - w // 8, device)
                ry, rx = _randint(g, k, h // 40, h // 10, device), _randint(g, k, w // 40, w // 10, device)
                color = torch.zeros(k, 3, device=device)
                color.scatter_(1, _randint(g, k, 0, 3, device).long()[:, None], _uniform(g, k, 200, 255, device)[:, None])
                texture = _uniform(g, k, 0.2, 0.5, device)
            else:
                cy, cx = _randint(g, k, 0, h, device), _randint(g, k, 0, w, device)
                ry, rx = _randint(g, k, h // 32, h // 6, device), _randint(g, k, w // 32, w // 6, device)
                color = _uniform(g, 3 * k, 40, 200, device).view(k, 3)
                texture = _uniform(g, k, 0, 0.15, device)
            cy, cx, ry, rx = (t[:, None, None] for t in (cy, cx, ry, rx))
            ellipse = (torch.rand(k, generator=g, device=device) < 0.5)[:, None, None]
            inside = torch.where(ellipse, ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0,
                                 ((yy - cy).abs() <= ry) & ((xx - cx).abs() <= rx))
            pitch = _randint(g, k, 6, 24, device)[:, None, None]
            tex = 1.0 + texture[:, None, None] * torch.sin(2 * math.pi * (xx + yy) / pitch)
            img = torch.where(inside[..., None], color[:, None, None, :] * tex[..., None], img)
            if anomaly:
                label[inside] = 1
        img += torch.randn(k, h, w, 3, generator=g, device=device) * 3
        label[:, :2] = 255
        yield img.clamp_(0, 255).to(torch.uint8), label
