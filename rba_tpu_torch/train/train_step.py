"""The training step (counterpart of ``rba_tpu/train/train_step.py``).

One step: ``preprocess``, ``maskformer_forward`` with deep supervision on ``rba_tpu``'s
training chain (``need_aux=True``, ``attention="xla"``), ``criterion`` with the
Hungarian matching on the card (Kernel E), backward, the global-norm clip and the
AdamW update with the poly schedule.  A per-pixel baseline head takes
``per_pixel_forward`` and its cross-entropy over ``sem_seg`` instead of the criterion
(no matching), each of the Plus head's decoder layers supervised.  ``grad_accum > 1`` splits the batch into that
many micro-batches and averages their gradients and losses before one update.  The
train state is the model, the optimizer, the step count and the ``torch.Generator``
that every random draw of the criterion comes from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import RbAConfig
from ..models.baseline_heads import per_pixel_losses
from ..models.maskformer import (RbAModel, build_model, is_per_pixel, maskformer_forward, per_pixel_forward,
                                 preprocess, resolve_device)
from ..ops.point_sample import uniform_from
from .criterion import criterion
from .optimizer import build_optimizer, clip_grads_, poly_lr_schedule, set_lr

SPANS = ("forward", "criterion", "backward", "optimizer")  # record_function spans of one step


@dataclass
class TrainState:
    model: RbAModel
    optimizer: torch.optim.Optimizer
    step: int
    gen: torch.Generator


def make_train_state(cfg: RbAConfig, device=None, seed: int = 0, model: Optional[RbAModel] = None) -> TrainState:
    """The model (seeded random weights unless one is given), its optimizer, step 0 and a
    generator seeded with ``seed``, on ``device``: by default the given model's device,
    else the card."""
    if model is None:
        model = build_model(cfg, device=resolve_device(device, "make_train_state"), seed=seed)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=build_optimizer(cfg, model), step=0, gen=gen)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v).to(
        device, non_blocking=True) for k, v in batch.items()}


def make_train_step(cfg: RbAConfig, grad_accum: int = 1, plain: bool = False):
    """A function (state, batch) -> metrics that updates ``state`` in place.  ``batch``:
    images (B, H, W, 3) raw RGB; gt_labels (B, T); gt_masks (B, T, H, W); gt_valid (B, T);
    optional outlier_masks and sem_seg (B, H, W); numpy or tensors.  The metrics are the
    weighted losses, ``total`` and ``grad_norm`` (the unclipped gradients' global norm),
    as 0-dim tensors on the card.  ``plain`` runs the plain LSAP instead of Kernel E.  A
    per-pixel head reads only images and sem_seg."""
    if not is_per_pixel(cfg) and cfg.decoder.name == "MultiScalePerPixelDecoder":
        raise ValueError("MultiScalePerPixelDecoder has no class head for the matcher (ROADMAP.md §C.18)")
    schedule = poly_lr_schedule(cfg.solver)

    def losses_of(model, batch, uniform):
        if is_per_pixel(cfg):
            with record_function("forward"):
                logits, aux = per_pixel_forward(model, cfg, preprocess(cfg, batch["images"]), attention="xla")
            with record_function("criterion"):
                losses = per_pixel_losses(cfg, uniform, logits, aux, batch["sem_seg"])
                losses["total"] = sum(losses.values())
                return losses
        with record_function("forward"):
            outputs = maskformer_forward(model, cfg, preprocess(cfg, batch["images"]), need_aux=True,
                                         attention="xla")
        with record_function("criterion"):
            targets = {k: v for k, v in batch.items() if k != "images"}
            return criterion(cfg, uniform, outputs, targets, plain=plain)

    def step_fn(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        model = state.model
        params = list(model.parameters())
        batch = to_device(batch, params[0].device)
        uniform = uniform_from(state.gen)
        n, micro = next(iter(batch.values())).shape[0], max(grad_accum, 1)
        if n % micro:
            raise ValueError(f"batch of {n} does not split into {micro} micro-batches")
        size = n // micro
        metrics: Dict[str, torch.Tensor] = {}
        for m in range(micro):
            mb = {k: v[m * size : (m + 1) * size] for k, v in batch.items()}
            losses = losses_of(model, mb, uniform)
            with record_function("backward"):
                (losses["total"] / micro).backward()
            for k, v in losses.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / micro
        with record_function("optimizer"), torch.no_grad():
            for p in params:  # a parameter outside the graph has a zero gradient, as in jax.grad
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            metrics["grad_norm"] = clip_grads_([p.grad for p in params], cfg.solver.clip_value)
            set_lr(state.optimizer, schedule(state.step))
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    return step_fn
