"""Data-parallel OOD evaluation (counterpart of ``rba_tpu/parallel/sharded_eval.py``).

``rba_tpu`` batches the images to the number of devices, scores the batch sharded over
``data`` and sums the devices' histograms.  Here each data rank takes the images of its
place in each batch of ``data`` images (image ``i`` goes to rank ``i mod data``), scores
them through ``maskformer_infer_rba`` on its own card (Kernels A and B) and bins them
into its histograms there; the tail batch is padded with repeats of its last image
labelled 255, which add nothing, as ``rba_tpu`` pads it.  One all-reduce over the data
group sums the histograms, and the metrics come from ``metrics_from_histograms``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import RbAConfig
from ..evalx.metrics import DEFAULT_BINS, DEFAULT_RANGE, _histogram_into, metrics_from_histograms, to_device
from ..models.maskformer import maskformer_infer_rba
from .mesh import Mesh


def _my_samples(dataset, n: int, rank: int, size: int):
    """(image, label) of each batch's slot ``rank``: a padded slot repeats the batch's
    last image with every label 255."""
    for start in range(0, n, size):
        i = start + rank
        if i < n:
            s = dataset[i]
            yield s.image, s.label
        else:
            s = dataset[n - 1]
            yield s.image, np.full_like(s.label, 255)


def sharded_histograms(cfg: RbAConfig, model, dataset, mesh: Mesh, upper_limit: int = 1300,
                       bins: int = DEFAULT_BINS) -> Tuple[np.ndarray, np.ndarray]:
    """(pos_hist, neg_hist) int64 of the first ``upper_limit`` images of an indexable
    dataset, summed over the data ranks; every rank of the group calls it and gets the
    sums."""
    n = min(len(dataset), upper_limit)
    device = next(model.parameters()).device
    counts = torch.zeros(2, bins, dtype=torch.int64, device=device)
    with torch.inference_mode():
        for image, label in _my_samples(dataset, n, mesh.data_rank, mesh.data_size):
            s = maskformer_infer_rba(model, cfg, to_device(image[None], device).float(), attention="fused")
            _histogram_into(counts, s[0], to_device(label.astype(np.uint8), device), bins, DEFAULT_RANGE, "linear")
    dist.all_reduce(counts, group=mesh.data_group)
    counts = counts.cpu().numpy()
    return counts[1], counts[0]


def evaluate_dataset_sharded(cfg: RbAConfig, model, dataset, mesh: Mesh, upper_limit: int = 1300,
                             bins: int = DEFAULT_BINS) -> Dict[str, float]:
    """{"auroc", "aupr", "fpr95"} of the RbA scores of the dataset, evaluated over the
    mesh's data ranks (fixed-resolution datasets, as every OOD suite is)."""
    pos, neg = sharded_histograms(cfg, model, dataset, mesh, upper_limit, bins)
    m = metrics_from_histograms(pos, neg)
    return {"auroc": m["AUROC"], "aupr": m["AUPRC"], "fpr95": m["FPR@95TPR"]}
