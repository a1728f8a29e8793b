"""Hungarian matcher, batched, on the card, exact (counterpart of ``rba_tpu/train/matcher.py``).

Per image: cost = class_weight · (−softmax probability of the target class) +
mask_weight · point-sampled sigmoid CE + dice_weight · point-sampled dice, with one
shared set of uniform points per image, then the exact assignment.  Targets are padded
to a static T per image; a padded target's row costs ``INVALID_COST`` everywhere and is
ignored downstream through ``gt_valid``.  The assignment is Kernel E
(``kernels/lsap.py``) where its ``takes`` says so, on the card, else its plain version
(``ops/lsap.py``), without gradient.

``fixed_match`` is the FixedMatcher: the target of class c goes to query c.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import LossConfig
from ..kernels import lsap as kernel
from ..ops.lsap import batched_linear_sum_assignment
from ..ops.point_sample import Uniform, point_sample

INVALID_COST = 1e6


def _batch_sigmoid_ce_cost(out_points: torch.Tensor, tgt_points: torch.Tensor) -> torch.Tensor:
    """(B, Q, P) logits × (B, T, P) targets → (B, Q, T) mean-over-points BCE."""
    p = out_points.shape[-1]
    pos = F.softplus(-out_points)
    neg = F.softplus(out_points)
    cost = torch.einsum("bqp,btp->bqt", pos, tgt_points) + torch.einsum("bqp,btp->bqt", neg, 1.0 - tgt_points)
    return cost / p


def _batch_dice_cost(out_points: torch.Tensor, tgt_points: torch.Tensor) -> torch.Tensor:
    probs = torch.sigmoid(out_points)
    numerator = 2.0 * torch.einsum("bqp,btp->bqt", probs, tgt_points)
    denominator = probs.sum(-1)[:, :, None] + tgt_points.sum(-1)[:, None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


@torch.no_grad()
def match_cost(
    uniform: Uniform,
    cfg: LossConfig,
    pred_logits: torch.Tensor,  # (B, Q, K+1)
    pred_masks: torch.Tensor,  # (B, Q, h, w)
    gt_labels: torch.Tensor,  # (B, T) int
    gt_masks: torch.Tensor,  # (B, T, H, W) 0/1
    gt_valid: torch.Tensor,  # (B, T) 0/1
) -> torch.Tensor:  # (B, T, Q) fp32: rows are the targets
    """The matching cost; one draw of (B, train_num_points, 2) uniform points."""
    b, q, _ = pred_logits.shape
    t = gt_labels.shape[1]
    if t > q:
        raise ValueError(f"padded target count ({t}) must be <= num_queries ({q}): every target needs a "
                         "distinct query; lower MapperConfig.max_instances")
    out_prob = torch.softmax(pred_logits.float(), dim=-1)
    cost_class = -torch.gather(out_prob, 2, gt_labels.long()[:, None, :].expand(-1, q, -1))  # (B, Q, T)
    coords = uniform((b, cfg.train_num_points, 2))
    out_points = point_sample(pred_masks.float(), coords)
    tgt_points = point_sample(gt_masks.float(), coords)
    cost = (cfg.mask_weight * _batch_sigmoid_ce_cost(out_points, tgt_points)
            + cfg.class_weight * cost_class
            + cfg.dice_weight * _batch_dice_cost(out_points, tgt_points))
    cost = cost.transpose(1, 2)
    return torch.where(gt_valid[:, :, None] > 0, cost, torch.full_like(cost, INVALID_COST)).contiguous()


def hungarian_match(uniform: Uniform, cfg: LossConfig, pred_logits, pred_masks, gt_labels, gt_masks,
                    gt_valid) -> torch.Tensor:
    """(B, T) int32 query assigned to each (padded) target."""
    cost = match_cost(uniform, cfg, pred_logits, pred_masks, gt_labels, gt_masks, gt_valid)
    solve = kernel.batched_linear_sum_assignment if kernel.takes(cost) else batched_linear_sum_assignment
    return solve(cost)


def fixed_match(gt_labels: torch.Tensor, num_queries: int) -> torch.Tensor:
    """FixedMatcher: the target of class c is matched to query c."""
    return gt_labels.clamp(0, num_queries - 1)
