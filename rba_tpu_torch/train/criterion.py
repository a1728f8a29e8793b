"""SetCriterion: the mask-classification losses and RbA's outlier-exposure losses
(counterpart of ``rba_tpu/train/criterion.py``).

- ``loss_labels``: cross-entropy over all queries, the no-object class at weight
  ``no_object_weight`` for the unmatched ones;
- ``loss_masks``: sigmoid CE and dice on importance-sampled points of each matched
  (query, target) pair;
- ``outlier_loss``: the RbA score of the class ⊗ mask einsum pushed below the inlier
  threshold and above the outlier one (squared hinge, or the bce / mse / l1 variants);
- ``smoothness_loss``, ``sparsity_loss``, ``gambler_loss`` (PEBAL) and
  ``densehybrid_loss``;
- ``criterion``: matching, the global ``num_masks``, deep supervision over
  ``aux_outputs``; it returns the weighted losses and their ``total``.

Under data parallelism (``group``: the mesh's data group) each rank holds its rows of the
global batch, and every sum over the batch (``num_masks``, each mean's numerator and
count, the ``has_ood`` conditions) is completed over the group in one all-reduce per loss
(``parallel.mesh.global_sums``) before the loss is formed, so every rank holds the global
batch's losses, as ``rba_tpu``'s step over its sharded batch computes them.  Without a
group the sums are the local ones and nothing is communicated.

The targets are padded and static: ``gt_labels`` (B, T) int, ``gt_masks`` (B, T, H, W),
``gt_valid`` (B, T), optional ``outlier_masks`` (B, H, W) in {0, 1, 255} and
``sem_seg`` (B, H, W).  Every random number comes from ``uniform`` (see
``ops/point_sample.py``), in ``rba_tpu``'s order of draws: for each supervised layer,
final first, the matcher's points and then the mask loss's two draws.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RbAConfig
from ..parallel.mesh import global_sums
from ..ops.point_sample import Uniform, point_sample, uncertain_point_coords
from ..ops.resize import resize_bilinear
from .matcher import fixed_match, hungarian_match


def _ratio(num, den, eps=1e-12):
    return num / torch.clamp(den, min=eps)




def loss_labels(cfg: RbAConfig, pred_logits, gt_labels, gt_valid, assignment, group=None):
    """Weighted CE over all queries; the unmatched ones take the no-object class K at
    weight ``no_object_weight``."""
    b, q, _ = pred_logits.shape
    k = cfg.num_classes
    target = torch.full((b, q), k, dtype=torch.long, device=pred_logits.device)
    # each query has at most one valid target and labels are < K, so a min-scatter of the
    # valid labels (padded targets write K to query 0) places them
    safe_q = torch.where(gt_valid > 0, assignment.long(), torch.zeros_like(assignment, dtype=torch.long))
    updates = torch.where(gt_valid > 0, gt_labels.long(), torch.full_like(gt_labels, k, dtype=torch.long))
    target = target.scatter_reduce(1, safe_q, updates, reduce="amin")
    logp = F.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, target[..., None])[..., 0]
    w = torch.where(target == k, cfg.loss.no_object_weight, 1.0)
    num, den = global_sums(group, torch.sum(nll * w), torch.sum(w))
    return num / den


def loss_masks(cfg: RbAConfig, uniform: Uniform, pred_masks, gt_masks, gt_valid, assignment, num_masks,
               group=None):
    """Point-sampled sigmoid CE and dice over the matched (query, target) pairs."""
    b, q, h, w = pred_masks.shape
    t = gt_masks.shape[1]
    bidx = torch.arange(b, device=pred_masks.device)[:, None]
    src = pred_masks[bidx, assignment.long()].float()  # (B, T, h, w)
    n = b * t
    src_flat = src.reshape(n, 1, h, w)
    tgt_flat = gt_masks.reshape(n, 1, gt_masks.shape[2], gt_masks.shape[3]).float()
    lc = cfg.loss
    coords = uncertain_point_coords(uniform, src_flat.detach(), lc.train_num_points, lc.oversample_ratio,
                                    lc.importance_sample_ratio)
    point_logits = point_sample(src_flat, coords)[:, 0]  # (N, P)
    with torch.no_grad():
        point_labels = point_sample(tgt_flat, coords)[:, 0]
    valid = gt_valid.reshape(n)

    ce = F.softplus(point_logits) - point_logits * point_labels

    probs = torch.sigmoid(point_logits)
    numerator = 2.0 * torch.sum(probs * point_labels, dim=1)
    denominator = probs.sum(dim=1) + point_labels.sum(dim=1)
    dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    s_mask, s_dice = global_sums(group, torch.sum(ce.mean(dim=1) * valid), torch.sum(dice * valid))
    return s_mask / num_masks, s_dice / num_masks


def _semantic_logits(pred_logits, pred_masks, drop_void=True):
    cls = torch.softmax(pred_logits.float(), dim=-1)
    if drop_void:
        cls = cls[..., :-1]
    return torch.einsum("bqc,bqhw->bchw", cls, torch.sigmoid(pred_masks.float()))


def _entropy(p):
    return torch.sum(-p * torch.log(torch.clamp(p, min=1e-20)), dim=1)


def _ood_score(cfg: RbAConfig, logits):
    """The score that the outlier loss pushes (``OUTLIER_LOSS_TARGET``)."""
    target = cfg.ood.outlier_loss_target
    if target == "nls":
        if cfg.ood.score_norm == "sigmoid":
            s = torch.sigmoid(logits)
        elif cfg.ood.score_norm == "tanh":
            s = torch.tanh(logits)
        else:
            s = logits
        return -s.sum(dim=1)
    if target == "energy":
        return -torch.logsumexp(logits, dim=1)
    if target == "softmax_entropy":
        return _entropy(torch.softmax(logits, dim=1))
    if target == "sum_entropy":
        return _entropy(logits / torch.sum(logits, dim=1, keepdim=True))
    raise ValueError(f"outlier_loss_target={target}")


def outlier_loss(cfg: RbAConfig, pred_logits, pred_masks, outlier_masks, group=None):
    """RbA's outlier-exposure loss."""
    score = _ood_score(cfg, _semantic_logits(pred_logits, pred_masks))  # (B, h, w)
    score = resize_bilinear(score[:, None], outlier_masks.shape[-2:], align_corners=True)[:, 0]
    ood = (outlier_masks == 1).float()
    inl = (outlier_masks == 0).float()
    fn = cfg.ood.outlier_loss_func
    thr_in = cfg.ood.inlier_upper_threshold
    thr_out = cfg.ood.outlier_lower_threshold
    if fn in ("max", "squared_hinge"):
        f_in, f_out = F.relu(score - thr_in) ** 2, F.relu(thr_out - score) ** 2
    elif fn == "binary_cross_entropy":
        total, count = global_sums(group, torch.sum(F.softplus(score) - score * ood),
                                   torch.tensor(float(score.numel()), device=score.device))
        return 0.5 * (total / count)
    elif fn == "mse":
        f_in, f_out = (score - thr_in) ** 2, (score - thr_out) ** 2
    elif fn == "l1":
        f_in, f_out = torch.abs(score - thr_in), torch.abs(score - thr_out)
    else:
        raise ValueError(f"outlier_loss_func={fn}")
    s_in, n_in, s_out, n_ood = global_sums(group, torch.sum(f_in * inl), torch.sum(inl), torch.sum(f_out * ood),
                                           torch.sum(ood))
    l_in, l_out = _ratio(s_in, n_in), _ratio(s_out, n_ood)
    return torch.where(n_ood > 0, 0.5 * (l_in + l_out), l_in)


def _smoothness_score(cfg: RbAConfig, logits):
    sc = cfg.ood.smoothness_score
    if sc in ("nls", "none"):
        return -logits.sum(dim=1)
    if sc == "energy":
        return -torch.logsumexp(logits, dim=1)
    return _entropy(torch.softmax(logits, dim=1))


def smoothness_loss(cfg: RbAConfig, pred_logits, pred_masks, group=None):
    """Squared differences of the score map with its h- and w-shifted self."""
    score = _smoothness_score(cfg, _semantic_logits(pred_logits, pred_masks))
    dh = score[:, 1:, :] - score[:, :-1, :]
    dw = score[:, :, 1:] - score[:, :, :-1]
    (total,) = global_sums(group, torch.sum(dh**2) + torch.sum(dw**2))
    return 0.5 * total


def sparsity_loss(cfg: RbAConfig, pred_logits, pred_masks, outlier_masks, group=None):
    """The L2 norm of the scores of the OOD pixels (grows as √N_ood, as the reference's)."""
    score = _smoothness_score(cfg, _semantic_logits(pred_logits, pred_masks))
    score = resize_bilinear(score[:, None], outlier_masks.shape[-2:], align_corners=True)[:, 0]
    (sq,) = global_sums(group, torch.sum((score * (outlier_masks == 1).float()) ** 2))
    # zero OOD pixels: 0 with a finite gradient
    return torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def _gaussian_blur_2d(x, ksize=7, sigma=1.0):
    """(B, H, W) separable Gaussian blur with reflect padding, H then W, taps in order."""
    half = ksize // 2
    g = np.exp(-0.5 * (np.arange(-half, half + 1) / sigma) ** 2)
    g = (g / g.sum()).astype(np.float32)
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x[:, None], (0, 0, half, half), mode="reflect")[:, 0]
    x = sum(xp[:, i : i + h, :] * float(g[i]) for i in range(ksize))
    xp = F.pad(x[:, None], (half, half, 0, 0), mode="reflect")[:, 0]
    return sum(xp[:, :, i : i + w] * float(g[i]) for i in range(ksize))


def gambler_loss(cfg: RbAConfig, pred_logits, pred_masks, outlier_masks, sem_seg, group=None):
    """PEBAL's gambler loss."""
    logits = _semantic_logits(pred_logits, pred_masks, drop_void=False)
    logits = resize_bilinear(logits, outlier_masks.shape[-2:], align_corners=True)
    probs = torch.softmax(logits, dim=1)
    true_pred, reservation = probs[:, :-1], probs[:, -1]
    reward = torch.logsumexp(logits[:, :-1], dim=1) ** 2
    reservation = reservation / _gaussian_blur_2d(reward, 7, 1.0)

    ood = outlier_masks == 1
    void = outlier_masks == 255
    labels = torch.where(void | ood, 0, sem_seg).long()
    gathered = torch.gather(true_pred, 1, labels[:, None])[:, 0]
    g_in = torch.log(torch.clamp(gathered + reservation, min=1e-7))
    keep = ((~ood) & (~void)).float()
    boost = torch.log(torch.clamp(true_pred + reservation[:, None], min=1e-7))
    ood_b = ood[:, None].expand_as(boost).float()
    s_in, n_in, s_out, n_out, n_ood = global_sums(group, torch.sum(g_in * keep), torch.sum(keep),
                                                  torch.sum(boost * ood_b), torch.sum(ood_b), torch.sum(ood.float()))
    loss_in = -_ratio(s_in, n_in)
    # PEBAL_OOD_REG; criterion() multiplies the whole loss by gambler_weight
    loss_out = -cfg.ood.ood_reg * _ratio(s_out, n_out)
    return torch.where(n_ood > 0, loss_in + loss_out, loss_in)


def densehybrid_loss(cfg: RbAConfig, pred_logits, pred_masks, ood_pred, outlier_masks, sem_seg, group=None):
    """DenseHybrid's loss: segmentation NLL, the OOD log-sum-exp term with its detached
    regulariser, and the (inlier, outlier) head's NLL over all pixels."""
    k = cfg.num_classes
    hw = outlier_masks.shape[-2:]
    logits = resize_bilinear(_semantic_logits(pred_logits, pred_masks), hw, align_corners=True)
    logits_ood = resize_bilinear(ood_pred.float(), hw, align_corners=True)
    cls_logp = F.log_softmax(logits, dim=1)
    ood_logp = F.log_softmax(logits_ood, dim=1)

    label_ood = (sem_seg == 254).float()
    lse = torch.logsumexp(logits, dim=1) * label_ood
    s, n = global_sums(group, torch.sum(logits).detach(), torch.tensor(float(logits.numel()), device=logits.device))
    mean_logits = s / n
    reg = -mean_logits * label_ood  # shifts the value, not the gradient

    labels = torch.where((sem_seg == 255) | (sem_seg == 254), k, sem_seg).long()
    valid = (labels < k).float()
    nll = -torch.gather(cls_logp, 1, labels.clamp(0, k - 1)[:, None])[:, 0]
    # the reference's ignore_index never ignores anything: the mean is over all pixels
    th = -torch.gather(ood_logp, 1, label_ood.long()[:, None])[:, 0]
    s_ood, n_ood, s_seg, n_seg, s_th, n_th = global_sums(
        group, torch.sum(lse + reg), torch.sum(label_ood), torch.sum(nll * valid), torch.sum(valid), torch.sum(th),
        torch.tensor(float(th.numel()), device=th.device))
    loss_ood = s_ood / torch.clamp(n_ood, min=1.0)
    loss_seg = _ratio(s_seg, n_seg)
    loss_th = s_th / n_th
    beta = cfg.ood.densehybrid_beta
    return loss_seg + beta * loss_ood + beta * 10.0 * loss_th


def criterion(cfg: RbAConfig, uniform: Uniform, outputs: Dict, targets: Dict, group=None) -> Dict[str, torch.Tensor]:
    """The weighted losses of every supervised layer and their ``total``.  ``group``: the
    data-parallel group whose ranks hold the rest of the batch (see the module docstring)."""
    gt_labels = targets["gt_labels"]
    gt_masks = targets["gt_masks"]
    gt_valid = targets["gt_valid"].float()
    (num_masks,) = global_sums(group, torch.sum(gt_valid))
    num_masks = torch.clamp(num_masks, min=1.0)
    w = cfg.loss
    ood = cfg.ood

    def layer_losses(preds, suffix=""):
        if w.matcher == "FixedMatcher":
            assignment = fixed_match(gt_labels, preds["pred_logits"].shape[1])
        else:
            assignment = hungarian_match(uniform, w, preds["pred_logits"], preds["pred_masks"], gt_labels,
                                         gt_masks, gt_valid)
        lc = loss_labels(cfg, preds["pred_logits"], gt_labels, gt_valid, assignment, group)
        lm, ld = loss_masks(cfg, uniform, preds["pred_masks"], gt_masks, gt_valid, assignment, num_masks, group)
        out = {f"loss_ce{suffix}": w.class_weight * lc,
               f"loss_mask{suffix}": w.mask_weight * lm,
               f"loss_dice{suffix}": w.dice_weight * ld}
        if ood.outlier_supervision and "outlier_masks" in targets:
            out[f"outlier_loss{suffix}"] = ood.outlier_weight * outlier_loss(
                cfg, preds["pred_logits"], preds["pred_masks"], targets["outlier_masks"], group)
        if ood.smoothness_loss:
            out[f"smoothness_loss{suffix}"] = ood.smoothness_weight * smoothness_loss(
                cfg, preds["pred_logits"], preds["pred_masks"], group)
        if ood.sparsity_loss and "outlier_masks" in targets:
            out[f"sparsity_loss{suffix}"] = ood.sparsity_weight * sparsity_loss(
                cfg, preds["pred_logits"], preds["pred_masks"], targets["outlier_masks"], group)
        return out

    losses = layer_losses(outputs)
    if ood.gambler_loss and "outlier_masks" in targets and "sem_seg" in targets:
        losses["gambler_loss"] = ood.gambler_weight * gambler_loss(
            cfg, outputs["pred_logits"], outputs["pred_masks"], targets["outlier_masks"], targets["sem_seg"], group)
    if ood.densehybrid_loss and "ood_pred" in outputs and "sem_seg" in targets:
        losses["densehybrid_loss"] = ood.densehybrid_weight * densehybrid_loss(
            cfg, outputs["pred_logits"], outputs["pred_masks"], outputs["ood_pred"], targets["outlier_masks"],
            targets["sem_seg"], group)
    if w.deep_supervision:
        for i, aux in enumerate(outputs.get("aux_outputs", [])):
            losses.update(layer_losses(aux, suffix=f"_{i}"))
    losses["total"] = sum(losses.values())
    return losses
