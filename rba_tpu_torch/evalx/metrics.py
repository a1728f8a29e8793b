"""OOD segmentation metrics: AUPRC (average precision), AUROC, FPR@95TPR.

Counterpart of ``rba_tpu/evalx/metrics.py``.  The streaming path bins every
pixel's score into fixed-width histograms on the scores' device (one scatter-add
per pixel, no host synchronisation), and computes the metrics from the counts on
the host in O(bins).  Binning loses only the ordering inside a bin, so
``metrics_from_histograms(with_bounds=True)`` also returns certified bounds on
the exact all-pixel metric; ``StreamingOODMetrics`` warns, and the evaluator
falls back to the exact path, when they are wider than ``QERR_TOL``.
``exact_ood_metrics`` is the sklearn-equivalent all-pixel computation in numpy.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# RbA scores are bounded: -Σ_k tanh ∈ [-K, K]; leave headroom for energy etc.
DEFAULT_RANGE = (-64.0, 64.0)
# 2^22 bins, 3.05e-5 wide: RbA scores concentrate in a narrow band (tanh
# saturation near ±K for trained weights, a tiny spread around 0 for random
# init), so a coarser histogram is coarse exactly where the mass is.
DEFAULT_BINS = 1 << 22
# asinh-space range covering every finite fp32 magnitude (asinh(3.4e38) ≈ 88.7):
# unbounded score functions can never saturate
ASINH_RANGE = (-90.0, 90.0)
ASINH_BINS = 1 << 22

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 names it trapz


def to_device(x, device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device`` without waiting for the device.
    A host array is copied through pinned memory asynchronously: a copy from pageable
    memory would first wait for all the work queued on the stream."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _bin_index(scores: torch.Tensor, bins: int, score_range, transform: str) -> torch.Tensor:
    """The int32 bin of every score, computed as rba_tpu computes it: float32
    arithmetic (the scale is a Python scalar, which torch applies in float32 as JAX
    applies its weak-typed constant), clip before and after a cast that truncates
    toward zero."""
    lo, hi = score_range
    s = scores.reshape(-1).float()
    if transform == "asinh":
        s = torch.asinh(s)
    s = s.clamp(lo, hi)
    idx = ((s - lo) * (bins / (hi - lo))).to(torch.int32)
    return idx.clamp_(0, bins - 1)


def _histogram_into(counts: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor, bins: int,
                    score_range, transform: str) -> None:
    """Add the scores' bins into ``counts`` (2, bins) int64: row 0 counts the inlier
    pixels (label 0), row 1 the anomalies (label 1); other labels add nothing.  One
    scatter-add per pixel, into the row its label selects."""
    idx = _bin_index(scores, bins, score_range, transform)
    lab = labels.reshape(-1)
    key = idx + (lab == 1).to(torch.int32) * bins
    scored = ((lab == 0) | (lab == 1)).to(torch.int64)
    counts.view(-1).index_add_(0, key, scored)


def histogram_update(
    scores: torch.Tensor,  # (…,) anomaly scores
    labels: torch.Tensor,  # (…,) int: 0 inlier, 1 anomaly, 255 ignore
    bins: int = DEFAULT_BINS,
    score_range: Tuple[float, float] = DEFAULT_RANGE,
    transform: str = "linear",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_hist, neg_hist) int64 histograms of the anomaly and inlier pixels' scores,
    on the scores' device; sum them across images.

    ``transform="asinh"`` bins asinh(score) instead of the score: asinh is strictly
    monotone and the metrics depend only on the ordering, so
    ``metrics_from_histograms`` is unchanged, and the log-spaced bins cover every
    finite fp32 score (``score_range`` is then in asinh space)."""
    counts = torch.zeros(2, bins, dtype=torch.int64, device=scores.device)
    _histogram_into(counts, scores, labels.to(scores.device), bins, score_range, transform)
    return counts[1], counts[0]


def _scored_range(scores: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of the scores of the pixels not ignored (label != 255), on the device."""
    s = scores.reshape(-1).float()
    scored = labels.reshape(-1) != 255
    return torch.where(scored, s, torch.inf).min(), torch.where(scored, s, -torch.inf).max()


def _harmonic_diff(a: np.ndarray, p: np.ndarray) -> np.ndarray:
    """H(a+p) − H(a) = Σ_{j=1..p} 1/(a+j), vectorized (a ≥ 0, p ≥ 0)."""
    try:
        from scipy.special import digamma
    except ImportError:  # asymptotic ψ with recurrence below x=16
        def digamma(x):
            x = np.asarray(x, np.float64).copy()
            acc = np.zeros_like(x)
            while np.any(small := x < 16.0):
                acc[small] -= 1.0 / x[small]
                x[small] += 1.0
            inv2 = 1.0 / (x * x)
            return acc + np.log(x) - 0.5 / x - inv2 * (1.0 / 12 - inv2 / 120)
    a = np.asarray(a, np.float64)
    p = np.asarray(p, np.float64)
    return digamma(a + p + 1.0) - digamma(a + 1.0)


def metrics_from_histograms(
    pos_hist: np.ndarray, neg_hist: np.ndarray, with_bounds: bool = False
) -> Dict[str, float]:
    """AUPRC / AUROC / FPR@95TPR from score histograms (host, O(bins)).

    Matches sklearn conventions: thresholds descend (high score = anomaly),
    average_precision = Σ (R_i − R_{i−1})·P_i, FPR95 = fpr at the first
    tpr > 0.95 on the ROC curve.

    ``with_bounds=True`` additionally returns CERTIFIED lower/upper bounds
    (keys ``<metric>_lo`` / ``<metric>_hi``) on the exact all-pixel metric:
    binning only loses the ordering *within* each bin, and every metric here
    is extremal when a bin's positives all rank above (or below) its
    negatives, so the exact value — whatever the true within-bin ordering or
    tie structure — provably lies in [lo, hi].  hi − lo is the streaming
    path's quantization error.
    """
    pos = np.asarray(pos_hist, np.float64)
    neg = np.asarray(neg_hist, np.float64)
    p_total = pos.sum()
    n_total = neg.sum()
    if p_total == 0 or n_total == 0:
        out = {"AUPRC": float("nan"), "AUROC": float("nan"), "FPR@95TPR": float("nan")}
        if with_bounds:
            for k in list(out):
                out[f"{k}_lo"] = out[f"{k}_hi"] = float("nan")
        return out

    # descending score order: reverse cumulative sums
    tp = np.cumsum(pos[::-1])
    fp = np.cumsum(neg[::-1])
    # keep only bins where threshold changes matter (nonzero counts)
    nz = (pos[::-1] + neg[::-1]) > 0
    p_i, n_i = pos[::-1][nz], neg[::-1][nz]
    tp, fp = tp[nz], fp[nz]

    tpr = tp / p_total
    fpr = fp / n_total
    precision = tp / np.maximum(tp + fp, 1)
    recall = tpr

    # average precision: sum over recall increments
    r_prev = np.concatenate([[0.0], recall[:-1]])
    auprc = float(np.sum((recall - r_prev) * precision))

    # AUROC: trapezoid over (fpr, tpr) with (0,0) prepended
    fpr_full = np.concatenate([[0.0], fpr])
    tpr_full = np.concatenate([[0.0], tpr])
    auroc = float(_trapezoid(tpr_full, fpr_full))

    # FPR at the first tpr strictly > 0.95 (the reference breaks on `if i > 0.95`)
    k = np.searchsorted(tpr, 0.95, side="right")
    k = min(k, len(fpr) - 1)
    fpr95 = float(fpr[k])
    out = {"AUPRC": auprc, "AUROC": auroc, "FPR@95TPR": fpr95}
    if not with_bounds:
        return out

    t_before = tp - p_i  # cumulative TP/FP from strictly higher bins
    f_before = fp - n_i
    has_p = p_i > 0

    # AP upper bound: all of a bin's positives tie in ONE group ranked above
    # its negatives — contribution (p/P)·(T+p)/(T+p+F), which dominates both
    # the distinct pos-first ordering and any finer grouping.
    ap_hi = float(np.sum(np.where(has_p, p_i * tp / np.maximum(tp + f_before, 1), 0.0)) / p_total)
    # AP lower bound: negatives first, positives distinct —
    # Σ_{j=1..p} (T+j)/(T+j+c) = p − c·(H(T+c+p) − H(T+c)), c = F + n.
    c = f_before + n_i
    ap_lo_terms = np.where(
        has_p, p_i - c * _harmonic_diff(t_before + c, np.where(has_p, p_i, 0.0)), 0.0
    )
    ap_lo = float(np.sum(ap_lo_terms) / p_total)

    # AUROC = P(pos > neg) + ½·P(tie): cross-bin pairs are fixed, within-bin
    # p·n pairs contribute 0 (neg-first) … p·n (pos-first).
    base = float(np.sum(p_i * (n_total - fp)) / (p_total * n_total))
    tie_mass = float(np.sum(p_i * n_i) / (p_total * n_total))
    auroc_lo, auroc_hi = base, base + tie_mass

    # FPR95: the 0.95-TPR crossing lands inside bin k (computed above on the
    # grouped curve, identical crossing bin for any within-bin ordering);
    # pos-first reaches it before any of that bin's negatives, neg-first
    # after all of them.
    fpr95_lo = float(f_before[k] / n_total)
    fpr95_hi = float((f_before[k] + n_i[k]) / n_total)

    out.update({
        "AUPRC_lo": ap_lo, "AUPRC_hi": ap_hi,
        "AUROC_lo": auroc_lo, "AUROC_hi": auroc_hi,
        "FPR@95TPR_lo": fpr95_lo, "FPR@95TPR_hi": fpr95_hi,
    })
    return out


def exact_ood_metrics(scores: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Exact (sklearn-equivalent) metrics from raw flattened pixels, in numpy: the
    reference's computation, used for official numbers and parity tests.  (rba_tpu
    may use its native radix-sort engine here; the port does not have it yet.)"""
    mask = labels != 255
    s = scores[mask].astype(np.float64)
    y = (labels[mask] == 1).astype(np.int64)
    if s.size == 0:  # every pixel ignored — guard before any indexing
        return {"AUPRC": float("nan"), "AUROC": float("nan"), "FPR@95TPR": float("nan")}
    order = np.argsort(-s, kind="mergesort")
    s, y = s[order], y[order]
    distinct = np.where(np.diff(s))[0]
    idxs = np.concatenate([distinct, [len(s) - 1]])

    tp = np.cumsum(y)[idxs]
    fp = (idxs + 1) - tp
    p_total = y.sum()
    n_total = len(y) - p_total
    if p_total == 0 or n_total == 0:
        return {"AUPRC": float("nan"), "AUROC": float("nan"), "FPR@95TPR": float("nan")}
    tpr = tp / p_total
    fpr = fp / n_total
    precision = tp / (tp + fp)
    r_prev = np.concatenate([[0.0], tpr[:-1]])
    auprc = float(np.sum((tpr - r_prev) * precision))
    auroc = float(_trapezoid(np.concatenate([[0.0], tpr]), np.concatenate([[0.0], fpr])))
    # first tpr strictly > 0.95, as the reference computes it
    k = np.searchsorted(tpr, 0.95, side="right")
    k = min(k, len(fpr) - 1)
    return {"AUPRC": auprc, "AUROC": auroc, "FPR@95TPR": float(fpr[k])}


class StreamingOODMetrics:
    """Per-image histograms accumulated on the device; one device-to-host copy at the
    end.  ``update`` and ``absorb`` queue device work and never wait for it, so the
    evaluation loop does not synchronise the host with the card per image; only
    ``clipped``, ``compute`` and ``certified`` read back.

    The counts are int64 on the device.  rba_tpu keeps int32 device counts (JAX runs
    without 64-bit mode) and flushes them into host int64 totals before a bin could
    overflow; with int64 on the device no bin can, so the port has no flush."""

    # certified quantization error above this (in metric units; 1e-4 =
    # 0.01 percentage points) triggers a warning here and the exact-path
    # fallback in evaluator.evaluate_dataset
    QERR_TOL = 1e-4

    def __init__(self, bins: Optional[int] = None, score_range=None,
                 transform: str = "linear", device="cuda"):
        """``transform="asinh"`` switches to log-spaced binning that covers every
        finite fp32 score (for unbounded score functions like the energy score);
        the defaults then become ASINH_BINS/ASINH_RANGE and saturation is
        impossible.  ``device`` holds the counts: the card unless the caller asks
        for another."""
        if transform not in ("linear", "asinh"):
            raise ValueError(f"unknown transform {transform!r}")
        self.transform = transform
        if bins is None:
            bins = ASINH_BINS if transform == "asinh" else DEFAULT_BINS
        if score_range is None:
            score_range = ASINH_RANGE if transform == "asinh" else DEFAULT_RANGE
        self.bins = bins
        self.range = score_range
        # row 0: inlier counts, row 1: anomaly counts
        self.counts = torch.zeros(2, bins, dtype=torch.int64, device=device)
        # running observed min/max over scored (non-ignore) pixels, so
        # unbounded scores that saturate the edge bins are detected instead of
        # silently distorting the metrics
        self.smin = torch.full((), torch.inf, device=device)  # a fill, not a blocking copy
        self.smax = torch.full((), -torch.inf, device=device)

    @property
    def pos(self) -> torch.Tensor:
        return self.counts[1]

    @property
    def neg(self) -> torch.Tensor:
        return self.counts[0]

    def update(self, scores: torch.Tensor, labels):
        """Add one image's (or batch's) scores and labels (0, 1, 255)."""
        labels = to_device(labels, self.counts.device)
        _histogram_into(self.counts, scores, labels, self.bins, self.range, self.transform)
        lo, hi = _scored_range(scores, labels)
        self.smin = torch.minimum(self.smin, lo)
        self.smax = torch.maximum(self.smax, hi)

    def absorb(self, dpos, dneg, smin, smax, n_pixels: int):
        """Merge device-computed histogram deltas — e.g. from a cohort
        (evaluator.make_cohort_fn) that scored k images and histogrammed them on
        the device.  The deltas must have been computed with this instance's
        bins/range/transform.  ``n_pixels`` is accepted for rba_tpu's signature,
        where it paced the int32 flush; the int64 counts here need no flush."""
        self.counts[1] += dpos
        self.counts[0] += dneg
        self.smin = torch.minimum(self.smin, smin)
        self.smax = torch.maximum(self.smax, smax)

    def _host_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        counts = self.counts.cpu().numpy()
        return counts[1], counts[0]

    @property
    def clipped(self) -> bool:
        lo, hi = self.range
        smin, smax = float(self.smin), float(self.smax)
        if self.transform == "asinh":
            smin, smax = np.arcsinh(smin), np.arcsinh(smax)
        return bool(smin < lo) or bool(smax > hi)

    def compute(self, with_bounds: bool = True) -> Dict[str, float]:
        if self.clipped:
            warnings.warn(
                f"StreamingOODMetrics: observed scores "
                f"[{float(self.smin):.3g}, {float(self.smax):.3g}] exceed the "
                f"histogram range {self.range}; edge bins are saturated — "
                f"re-run with a wider score_range or the exact path",
                stacklevel=2,
            )
        m = metrics_from_histograms(*self._host_counts(), with_bounds=with_bounds)
        if with_bounds:
            qerr = self.quantization_error(m)
            if any(v > self.QERR_TOL for v in qerr.values()):
                warnings.warn(
                    f"StreamingOODMetrics: certified quantization error "
                    f"{ {k: round(v, 6) for k, v in qerr.items()} } exceeds "
                    f"{self.QERR_TOL} ({self.QERR_TOL * 100:.2g} pts) — use "
                    f"the exact path for official numbers",
                    stacklevel=2,
                )
        return m

    @staticmethod
    def quantization_error(m: Dict[str, float]) -> Dict[str, float]:
        """Certified |exact − streaming| ceiling per metric (hi − lo of the
        within-bin-ordering bounds), from a compute(with_bounds=True) dict."""
        return {
            k: m[f"{k}_hi"] - m[f"{k}_lo"]
            for k in ("AUPRC", "AUROC", "FPR@95TPR")
            if f"{k}_hi" in m and np.isfinite(m[f"{k}_hi"])
        }

    def certified(self, tol: Optional[float] = None) -> bool:
        """True when every metric's certified quantization error is within
        ``tol`` (default QERR_TOL) and no scores were clipped."""
        if self.clipped:
            return False
        m = metrics_from_histograms(*self._host_counts(), with_bounds=True)
        qerr = self.quantization_error(m)
        t = self.QERR_TOL if tol is None else tol
        return all(v <= t for v in qerr.values())
