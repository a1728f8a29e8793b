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

Several GPUs (``mesh``, ``parallel/mesh.py``): each data rank runs the step on its rows
of the global batch (``parallel.mesh.shard_batch``), draws every random number at the
global batch's shape and takes its rows, completes the criterion's batch sums over the
data group, and all-reduces the gradients over that group in buckets once per step,
after the last micro-batch and before the clip.  The result is the 1-rank step's on the
global batch, as ``rba_tpu``'s step jitted over its sharded batch is: the same losses on
every rank, the global gradient, the same update.  ``tp=True`` splits the MLPs over the
mesh's model axis (``parallel/tp.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RbAConfig
from ..models.baseline_heads import per_pixel_losses
from ..models.maskformer import (RbAModel, build_model, is_per_pixel, maskformer_forward, per_pixel_forward,
                                 preprocess, resolve_device)
from ..ops.point_sample import uniform_from
from ..parallel.mesh import COUNTS, Mesh
from ..parallel.tp import grad_norm_tp, shard_params_tp
from ..utils.profiling import span
from .criterion import criterion
from .optimizer import build_optimizer, clip_grads_, poly_lr_schedule, set_lr

BUCKET_BYTES = 25 * 2**20  # gradient all-reduce bucket, DistributedDataParallel's default size


@dataclass
class TrainState:
    model: RbAModel
    optimizer: torch.optim.Optimizer
    step: int
    gen: torch.Generator


def make_train_state(cfg: RbAConfig, device=None, seed: int = 0, model: Optional[RbAModel] = None,
                     mesh: Optional[Mesh] = None, tp: bool = False) -> TrainState:
    """The model (seeded random weights unless one is given), its optimizer, step 0 and a
    generator seeded with ``seed``, on ``device``: by default the given model's device,
    else the card.  ``tp=True`` keeps this rank's slices of the MLPs on ``mesh``'s model
    axis (``parallel.tp.shard_params_tp``) before the optimizer is built."""
    if model is None:
        model = build_model(cfg, device=resolve_device(device, "make_train_state"), seed=seed)
    if tp:
        shard_params_tp(model, mesh)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=build_optimizer(cfg, model), step=0, gen=gen)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v).to(
        device, non_blocking=True) for k, v in batch.items()}


def grad_buckets(params: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The parameters in all-reduce buckets: consecutive runs of one dtype and device of
    at most ``BUCKET_BYTES`` (a larger tensor alone)."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for p in params:
        nbytes = p.numel() * p.element_size()
        last = buckets[-1] if buckets else None
        if last is None or size + nbytes > BUCKET_BYTES or (last[0].dtype, last[0].device) != (p.dtype, p.device):
            buckets.append([])
            size = 0
        buckets[-1].append(p)
        size += nbytes
    return buckets


@torch.no_grad()
def all_reduce_grads(params: List[torch.Tensor], group) -> None:
    """Sum every parameter's gradient over ``group``, one all-reduce per bucket."""
    for bucket in grad_buckets(params):
        flat = torch.cat([p.grad.reshape(-1) for p in bucket])
        dist.all_reduce(flat, group=group)
        COUNTS["grad"] += 1
        start = 0
        for p in bucket:
            n = p.numel()
            p.grad.copy_(flat[start : start + n].view_as(p.grad))
            start += n


def make_train_step(cfg: RbAConfig, grad_accum: int = 1, mesh: Optional[Mesh] = None, tp: bool = False):
    """A function (state, batch) -> metrics that updates ``state`` in place.  ``batch``:
    images (B, H, W, 3) raw RGB; gt_labels (B, T); gt_masks (B, T, H, W); gt_valid (B, T);
    optional outlier_masks and sem_seg (B, H, W); numpy or tensors.  The metrics are the
    weighted losses, ``total`` and ``grad_norm`` (the unclipped gradients' global norm),
    as 0-dim tensors on the card.  A per-pixel head reads only images and sem_seg.

    With ``mesh`` the batch is this data rank's rows of the global batch, micro-batch by
    micro-batch (``parallel.mesh.shard_batch(mesh, batch, grad_accum)``), and the metrics
    are the global batch's; ``tp`` takes a state made with ``tp=True``."""
    if not is_per_pixel(cfg) and cfg.decoder.name == "MultiScalePerPixelDecoder":
        raise ValueError("MultiScalePerPixelDecoder has no class head for the matcher (ROADMAP.md §C.18)")
    schedule = poly_lr_schedule(cfg.solver)

    group = None if mesh is None else mesh.data_group
    shard = (0, 1) if mesh is None else (mesh.data_rank, mesh.data_size)

    def losses_of(model, batch, uniform):
        if is_per_pixel(cfg):
            with span("forward"):
                logits, aux = per_pixel_forward(model, cfg, preprocess(cfg, batch["images"]), attention="xla")
            with span("criterion"):
                losses = per_pixel_losses(cfg, uniform, logits, aux, batch["sem_seg"], group)
                losses["total"] = sum(losses.values())
                return losses
        with span("forward"):
            outputs = maskformer_forward(model, cfg, preprocess(cfg, batch["images"]), need_aux=True,
                                         attention="xla")
        with span("criterion"):
            targets = {k: v for k, v in batch.items() if k != "images"}
            return criterion(cfg, uniform, outputs, targets, group=group)

    def step_fn(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        model = state.model
        params = list(model.parameters())
        batch = to_device(batch, params[0].device)
        uniform = uniform_from(state.gen, shard)
        n, micro = next(iter(batch.values())).shape[0], max(grad_accum, 1)
        if n % micro:
            raise ValueError(f"batch of {n} does not split into {micro} micro-batches")
        size = n // micro
        metrics: Dict[str, torch.Tensor] = {}
        for m in range(micro):
            mb = {k: v[m * size : (m + 1) * size] for k, v in batch.items()}
            losses = losses_of(model, mb, uniform)
            with span("backward"):
                (losses["total"] / micro).backward()
            for k, v in losses.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / micro
        with span("optimizer"), torch.no_grad():
            for p in params:  # a parameter outside the graph has a zero gradient, as in jax.grad
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if group is not None:
                all_reduce_grads(params, group)
            if tp:
                norm = grad_norm_tp(model, mesh)
                clip_grads_([p.grad for p in params], cfg.solver.clip_value, norm=norm)
                metrics["grad_norm"] = norm
            else:
                metrics["grad_norm"] = clip_grads_([p.grad for p in params], cfg.solver.clip_value)
            set_lr(state.optimizer, schedule(state.step))
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    return step_fn
