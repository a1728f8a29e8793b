"""The helpers of the reference RbA code's ``support.py`` on the port's model (counterpart
of ``rba_tpu/evalx/support.py``): score-function variants, the logistic squashing
helper, image and mask conveniences, and matplotlib drawing helpers.

The model's functions take (B, H, W, 3) raw RGB images (numpy or tensors) and return
tensors on the model's device.  ``get_datasets`` lives in ``rba_tpu_torch.data.ood_datasets``,
``OODEvaluator`` in ``rba_tpu_torch.evalx.evaluator``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import RbAConfig
from ..models.maskformer import maskformer_infer
from ..ops.resize import resize_bilinear


def _infer(model, cfg: RbAConfig, images, attention: str):
    x = torch.as_tensor(images).to(next(model.parameters()).device).float()
    return maskformer_infer(model, cfg, x, attention=attention)


def get_logits(model, cfg: RbAConfig, images, attention: str = "fused") -> torch.Tensor:
    """(B, H, W, 3) raw RGB → (B, K, H, W) sem_seg logits."""
    return _infer(model, cfg, images, attention)["sem_seg"]


def get_logits_plus(model, cfg: RbAConfig, images, return_aux: bool = False, attention: str = "fused"):
    """The logits, and with ``return_aux`` the other outputs by name."""
    out = _infer(model, cfg, images, attention)
    if return_aux:
        return out["sem_seg"], {k: v for k, v in out.items() if k != "sem_seg"}
    return out["sem_seg"]


def get_neg_logit_sum(model, cfg: RbAConfig, images, attention: str = "fused") -> torch.Tensor:
    """Anomaly score −Σ_k logit_k."""
    return -get_logits(model, cfg, images, attention).sum(dim=1)


def get_RbA(model, cfg: RbAConfig, images, attention: str = "fused") -> torch.Tensor:
    """Anomaly score −Σ_k tanh(logit_k)."""
    return -torch.tanh(get_logits(model, cfg, images, attention)).sum(dim=1)


def logistic(x, k: float = 1.0, x0: float = 0.0, L: float = 1.0) -> torch.Tensor:
    return L / (1.0 + torch.exp(-k * (torch.as_tensor(x) - x0)))


def resize_mask(m, shape) -> torch.Tensor:
    """Bilinear (``align_corners=False``) resize of the last two axes to ``shape``."""
    return resize_bilinear(torch.as_tensor(m), (int(shape[0]), int(shape[1])))


def proc_img(img) -> np.ndarray:
    """CHW → HWC for plotting."""
    arr = np.asarray(img.cpu() if isinstance(img, torch.Tensor) else img).copy()
    if arr.ndim == 3 and arr.shape[0] == 3:
        arr = arr.transpose(1, 2, 0)
    return arr


def get_seg_colormap(preds, colors: Sequence) -> np.ndarray:
    """(H, W) class-id map → (H, W, 3) int color map."""
    preds = np.asarray(preds.cpu() if isinstance(preds, torch.Tensor) else preds)
    color_map = np.zeros(preds.shape + (3,), np.int64)
    for i, c in enumerate(colors):
        mask = preds == i
        if mask.any():
            color_map[mask] = np.asarray(c)
    return color_map


def show_mask(mask, ax, random_color: bool = False):
    """Overlay a binary mask on a matplotlib axis."""
    if random_color:
        color = np.concatenate([np.random.random(3), [0.6]])
    else:
        color = np.array([30 / 255, 144 / 255, 255 / 255, 0.6])
    mask = np.asarray(mask)
    h, w = mask.shape[-2:]
    ax.imshow(mask.reshape(h, w, 1) * color.reshape(1, 1, -1))


def show_points(coords, labels, ax, marker_size: int = 375):
    coords, labels = np.asarray(coords), np.asarray(labels)
    pos, neg = coords[labels == 1], coords[labels == 0]
    ax.scatter(pos[:, 0], pos[:, 1], color="green", marker="*", s=marker_size, edgecolor="white", linewidth=1.25)
    ax.scatter(neg[:, 0], neg[:, 1], color="red", marker="*", s=marker_size, edgecolor="white", linewidth=1.25)


def show_box(box, ax):
    import matplotlib.pyplot as plt

    x0, y0 = box[0], box[1]
    w, h = box[2] - box[0], box[3] - box[1]
    ax.add_patch(plt.Rectangle((x0, y0), w, h, edgecolor="green", facecolor=(0, 0, 0, 0), lw=2))


def show_anns(anns, strength: float = 0.35):
    """Overlay a list of {"segmentation", "area"} dicts on the current axis."""
    if len(anns) == 0:
        return
    import matplotlib.pyplot as plt

    ax = plt.gca()
    ax.set_autoscale_on(False)
    for ann in sorted(anns, key=lambda a: a["area"], reverse=True):
        m = np.asarray(ann["segmentation"])
        img = np.ones(m.shape + (3,)) * np.random.random(3)
        ax.imshow(np.dstack((img, m * strength)))
