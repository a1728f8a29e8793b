"""AdamW with Detectron2's per-module hyperparameters (counterpart of ``rba_tpu/train/optimizer.py``).

``rba_tpu`` chains optax transforms over the parameter pytree: a global-norm clip over
all gradients, Adam, decoupled weight decay on the decay-eligible leaves, a per-leaf
multiplier (backbone × ``backbone_multiplier``, frozen × 0), and ``-schedule(count)``
with ``count`` from 0.  Here ``clip_grads_`` does the clip in optax's form (no
``+1e-6`` as ``clip_grad_norm_`` has; frozen leaves count) and one ``torch.optim.AdamW``
with a group per (multiplier, decay) does the rest: AdamW's lr·wd·p decay and its
lr·m̂/(√v̂ + ε) step are optax's chain with lr = multiplier · schedule.  The
predicates read ``rba_tpu``'s tree paths, which ``convert.params.jax_path`` derives from
each parameter's name.  ``freeze_transformer_decoder_except_mlp`` and
``_except_object_queries`` are read and ignored, as ``rba_tpu`` ignores them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import RbAConfig, SolverConfig
from ..convert.params import jax_path


def is_no_decay(path: str) -> bool:
    """Norms, bias tables and embeddings take no weight decay."""
    p = path.lower()
    if "relative_position_bias_table" in p or "absolute_pos_embed" in p:
        return True
    if "query_feat" in p or "query_embed" in p or "level_embed" in p:
        return True
    return any("norm" in seg or seg == "gn" for seg in p.split("/"))


def is_backbone(path: str) -> bool:
    return path.startswith("backbone")


def lr_multiplier(solver: SolverConfig, path: str) -> float:
    mult = solver.backbone_multiplier if is_backbone(path) else 1.0
    if solver.freeze_backbone and is_backbone(path):
        mult = 0.0
    if solver.freeze_pixel_decoder and "pixel_decoder" in path:
        mult = 0.0
    if solver.freeze_transformer_decoder and "predictor" in path:
        mult = 0.0
    return mult


def poly_lr_schedule(solver: SolverConfig):
    """WarmupPolyLR: base_lr · warmup · max((1 − step / max_iter)^power, constant_ending)."""
    def schedule(step: int) -> float:
        step = min(step, solver.max_iter)
        warm = (solver.warmup_factor + (1 - solver.warmup_factor) * step / max(solver.warmup_iters, 1)
                if step < solver.warmup_iters else 1.0)
        poly = max((1.0 - step / solver.max_iter) ** solver.poly_lr_power, solver.poly_lr_constant_ending)
        return solver.base_lr * warm * poly

    return schedule


def param_groups(cfg: RbAConfig, model: nn.Module) -> List[Dict]:
    """One AdamW group per (lr multiplier, decay) pair; each group keeps its multiplier."""
    groups: Dict[Tuple[float, bool], List[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        path = jax_path(name, p.dim())
        groups.setdefault((lr_multiplier(cfg.solver, path), not is_no_decay(path)), []).append(p)
    return [dict(params=ps, lr_mult=mult, weight_decay=cfg.solver.weight_decay if decay else 0.0)
            for (mult, decay), ps in sorted(groups.items())]


def build_optimizer(cfg: RbAConfig, model: nn.Module) -> torch.optim.AdamW:
    return torch.optim.AdamW(param_groups(cfg, model), lr=cfg.solver.base_lr, betas=(0.9, 0.999), eps=1e-8)


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ over all gradients of Σ g²), as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


@torch.no_grad()
def clip_grads_(grads, max_norm: float, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: g ← g / ‖g‖ · max_norm where ‖g‖ >= max_norm.
    Returns the unclipped norm; ``norm`` gives it where the gradients are sharded
    (``parallel.tp.grad_norm_tp``)."""
    if norm is None:
        norm = global_norm(grads)
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
