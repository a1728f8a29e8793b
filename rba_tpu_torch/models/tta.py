"""Test-time augmentation: multi-scale and horizontal-flip averaging (counterpart of
``rba_tpu/models/tta.py``).

After the reference's ``SemanticSegmentorWithTTA``: the model runs on each (scale,
flip) variant of the image, flipped ``sem_seg`` outputs are flipped back, and the
class-probability maps are averaged at the original resolution.  The scales are
``TEST.AUG.MIN_SIZES`` under Detectron2's ``ResizeShortestEdge``: the shortest edge to
each size, the longest capped at ``TEST.AUG.MAX_SIZE``.  The image and the running sum
stay on the model's device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import RbAConfig
from ..ops.resize import resize_bilinear_nhwc
from .maskformer import maskformer_infer


def resize_shortest_edge_size(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
    """(h, w) with the shortest edge scaled to ``size`` and the longest at most
    ``max_size``, each rounded half up."""
    scale = size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def tta_variants(cfg: RbAConfig, h: int, w: int, min_sizes: Optional[Sequence[int]] = None,
                 flip: Optional[bool] = None):
    """The (height, width, flipped) of each variant of an h×w image, in the order they
    run; the config's ``TEST.AUG`` values where ``min_sizes`` / ``flip`` are None."""
    min_sizes = tuple(min_sizes if min_sizes is not None else cfg.test.aug_min_sizes)
    flip = cfg.test.aug_flip if flip is None else flip
    return [(*resize_shortest_edge_size(h, w, s, cfg.test.aug_max_size), flipped)
            for s in min_sizes for flipped in ((False, True) if flip else (False,))]


@torch.inference_mode()
def tta_inference(
    model,
    cfg: RbAConfig,
    image,  # (H, W, 3) raw RGB, numpy or tensor
    min_sizes: Optional[Sequence[int]] = None,
    flip: Optional[bool] = None,
    attention: str = "fused",
    plain: bool = False,
) -> torch.Tensor:  # (K, H, W) fp32 on the model's device
    """Averaged sem_seg probabilities over all augmentations, each variant through Swin's
    ``attention`` branch (``plain``: the kernels' plain versions)."""
    h, w = image.shape[:2]
    img = torch.as_tensor(image).to(next(model.parameters()).device).float()[None]
    variants = tta_variants(cfg, h, w, min_sizes, flip)
    total = None
    for hh, ww, flipped in variants:
        x = resize_bilinear_nhwc(img, (hh, ww))
        if flipped:
            x = torch.flip(x, dims=[2])
        sem = maskformer_infer(model, cfg, x, out_hw=(h, w), attention=attention, plain=plain)["sem_seg"]
        if flipped:
            sem = torch.flip(sem, dims=[-1])
        total = sem[0] if total is None else total + sem[0]
    return total / len(variants)
