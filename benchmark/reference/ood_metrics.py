"""Exact all-pixel OOD metrics, as scikit-learn defines them: AUROC, average precision
(AUPRC) and the false-positive rate at the first threshold whose true-positive rate
exceeds 0.95.  Pixels labelled 1 are anomalies, 0 inliers; every other label is void.

Plain PyTorch so that it sorts tens of millions of pixels on the card; counts and sums
in int64 and float64."""
from __future__ import annotations

from typing import Dict

import torch


def ood_metrics(scores: torch.Tensor, labels: torch.Tensor) -> Dict[str, float]:
    """{"auroc", "aupr", "fpr95"} of the scores (higher: more anomalous)."""
    scores, labels = scores.reshape(-1), labels.reshape(-1)
    scored = (labels == 0) | (labels == 1)
    s = scores[scored].float()
    pos = (labels[scored] == 1).to(torch.int64)
    s, order = torch.sort(s, descending=True)
    pos = pos[order]
    # the last pixel of each run of equal scores is a threshold
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    tps = torch.cumsum(pos, 0)[last].double()
    fps = (torch.nonzero(last).reshape(-1) + 1).double() - tps
    p_total, n_total = tps[-1], fps[-1]
    tpr, fpr = tps / p_total, fps / n_total
    zero = torch.zeros(1, dtype=torch.float64, device=s.device)
    tpr0, fpr0 = torch.cat([zero, tpr]), torch.cat([zero, fpr])
    auroc = torch.sum((fpr0[1:] - fpr0[:-1]) * (tpr0[1:] + tpr0[:-1]) / 2)
    aupr = torch.sum((tpr0[1:] - tpr0[:-1]) * tps / (tps + fps))
    k = min(int(torch.searchsorted(tpr, torch.tensor([0.95], dtype=torch.float64, device=s.device),
                                   right=True)), len(fpr) - 1)
    return {"auroc": float(auroc), "aupr": float(aupr), "fpr95": float(fpr[k])}
