"""OOD evaluator: inference on the model's device plus the OOD metrics.

Counterpart of ``rba_tpu/evalx/evaluator.py``, after the reference RbA code's
``OODEvaluator`` (``compute_anomaly_scores`` at batch 1 with an ``upper_limit``
cap and optional Gaussian smoothing; ``evaluate_ood`` over all pixels;
``evaluate_ood_bootstrapped``) and its score functions (RbA, energy/PEBAL,
DenseHybrid).

The port passes the ``RbAModel`` where rba_tpu passes ``params``; everything runs
on the model's device.  Images go up as uint8 and are cast there.  The default
streaming path (``evaluate_dataset``) bins every image's scores into histograms on
the device, so full-resolution score maps never come back to the host; the
exact path (``compute_anomaly_scores`` + ``evaluate_ood``) reproduces the
reference's all-pixel computation.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RbAConfig, check_supported
from ..models.maskformer import energy_score, maskformer_infer, maskformer_infer_rba, rba_score
from ..ops.quant import is_quantized, quantize_params_int8
from .metrics import StreamingOODMetrics, _histogram_into, _scored_range, exact_ood_metrics, to_device

# score functions that are unbounded and stream into asinh-binned histograms
_UNBOUNDED = ("pebal", "energy", "dense_hybrid")


def _gaussian_kernel(ksize=7, sigma=1.0):
    half = ksize // 2
    g = np.exp(-0.5 * (np.arange(-half, half + 1) / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _gaussian_blur(score: torch.Tensor, ksize=7, sigma=1.0) -> torch.Tensor:
    """(B, H, W) separable blur with reflect padding, as torchvision's GaussianBlur
    pads (the reference applies it over the full map)."""
    k = torch.as_tensor(_gaussian_kernel(ksize, sigma), device=score.device)
    half = ksize // 2
    x = F.pad(score, (0, 0, half, half), mode="reflect")
    x = sum(x[:, i : i + score.shape[1], :] * k[i] for i in range(ksize))
    x = F.pad(x, (half, half), mode="reflect")
    return sum(x[:, :, i : i + score.shape[2]] * k[i] for i in range(ksize))


def prefetch(dataset, limit: int, depth: int = 3):
    """Iterate ``dataset`` with a background decode thread so host image IO and
    decode overlap device compute."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: list = []

    def producer():
        # the sentinel MUST reach the queue even when decode raises
        # (corrupt/missing image), or the consumer blocks forever; the
        # exception is carried across and re-raised on the main thread
        try:
            for i, sample in enumerate(dataset):
                if i >= limit:
                    break
                q.put(sample)
        except BaseException as e:  # noqa: BLE001 — relayed below
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if err:
                raise err[0]
            break
        yield item


def _score_batch(model, cfg: RbAConfig, images: torch.Tensor, score: str, smoothing: bool,
                 attention: str = "fused") -> torch.Tensor:
    """(B, H, W, 3) images on the model's device → (B, H, W) fp32 anomaly scores, through
    Swin's ``attention`` branch."""
    if score == "rba" and not smoothing:
        # the fused RbA tail; exact because evaluation feeds original-resolution images
        return maskformer_infer_rba(model, cfg, images, attention=attention)
    out = maskformer_infer(model, cfg, images, attention=attention)
    logits = out["sem_seg"]
    if score == "rba":
        s = rba_score(logits)
    elif score in ("pebal", "energy"):
        s = energy_score(logits)
    elif score == "dense_hybrid":
        if "ood_pred" not in out:
            raise ValueError("score 'dense_hybrid' needs the DenseHybrid ood_pred head "
                             "(MODEL.MASK_FORMER.DENSE_HYBRID_LOSS, DecoderConfig.ood_prediction)")
        p_ood = torch.softmax(out["ood_pred"], dim=1)[:, 1]
        s = -torch.logsumexp(logits, dim=1) + torch.log(p_ood + 1e-9)
    else:
        raise ValueError(score)
    if smoothing:
        s = _gaussian_blur(s)
    return s


def _device(model) -> torch.device:
    return next(model.parameters()).device


def serving_model(cfg: RbAConfig, model):
    """The model that scores under ``cfg``: with ``weight_quant="int8"`` an int8 copy
    (``ops.quant.quantize_params_int8``; a model already in int8 as it is), as
    ``rba_tpu``'s score functions quantize their parameters."""
    if cfg.weight_quant == "int8" and not is_quantized(model):
        return quantize_params_int8(model, cfg=cfg)
    return model


def make_score_fn(cfg: RbAConfig, model, score: str = "rba", smoothing: bool = False, attention: str = "fused"):
    """(image batch, uint8 numpy or tensor) → (B, H, W) anomaly scores on the model's
    device.  Host images go up as uint8 (4x fewer bytes) and are cast there."""
    check_supported(cfg)
    device = _device(model)
    model = serving_model(cfg, model)

    def score_fn(images) -> torch.Tensor:
        return _score_batch(model, cfg, to_device(images, device).float(), score, smoothing, attention)

    return score_fn


def make_cohort_fn(cfg: RbAConfig, model, score: str, smoothing: bool,
                   bins: int, score_range, transform: str, attention: str = "fused"):
    """Cohort scoring: takes a packed (k, H, W, 4) uint8 array (RGB image + label
    plane), uploaded in one host-to-device copy, scores each image at batch 1 and
    accumulates (pos, neg) score histograms and the observed min/max on the device;
    nothing full-resolution returns to the host."""
    check_supported(cfg)
    device = _device(model)
    model = serving_model(cfg, model)

    def cohort_fn(packed):
        packed = to_device(packed, device)
        counts = torch.zeros(2, bins, dtype=torch.int64, device=device)
        lo = torch.full((), torch.inf, device=device)  # a fill, not a blocking copy
        hi = torch.full((), -torch.inf, device=device)
        for img, lab in zip(packed[..., :3], packed[..., 3]):
            s = _score_batch(model, cfg, img[None].float(), score, smoothing, attention)[0]
            _histogram_into(counts, s, lab, bins, score_range, transform)
            s_lo, s_hi = _scored_range(s, lab)
            lo, hi = torch.minimum(lo, s_lo), torch.maximum(hi, s_hi)
        return counts[1], counts[0], lo, hi

    return cohort_fn


def _names(m: Dict[str, float]) -> Dict[str, float]:
    """The reference's key names."""
    return {"auroc": m["AUROC"], "aupr": m["AUPRC"], "fpr95": m["FPR@95TPR"]}


class OODEvaluator:
    """The reference's OODEvaluator on the port's model.

    ``score`` may be a name ("rba" | "pebal"/"energy" | "dense_hybrid") or a
    custom callable (images_uint8 (B,H,W,3) → (B,H,W) scores), mirroring the
    reference's pluggable ``anomaly_score_func``.  ``attention`` is Swin's
    window-attention branch (``"fused"``, ``"fused_softmax"`` or ``"xla"``; see
    ``models/swin.py``), the port's counterpart of ``rba_tpu``'s environment switches."""

    def __init__(self, cfg: RbAConfig, model, score="rba", use_gaussian_smoothing: bool = False,
                 attention: str = "fused"):
        self.cfg = cfg
        self.model = model = serving_model(cfg, model)
        self.attention = attention
        self.device = _device(model)
        self.score_name = score if isinstance(score, str) else None
        self.smoothing = use_gaussian_smoothing
        if callable(score):
            self.score_fn = score
        else:
            self.score_fn = make_score_fn(cfg, model, score, use_gaussian_smoothing, attention)

    # ------------------------------------------------------------------
    # reference-parity (exact) path
    # ------------------------------------------------------------------
    def compute_anomaly_scores(self, dataset, upper_limit: int = 1300, return_preds: bool = False):
        """Loop over the dataset, return stacked (N, H, W) scores + labels."""
        scores, gts, preds = [], [], []
        for sample in prefetch(dataset, upper_limit):
            s = self.score_fn(sample.image[None])
            scores.append(s[0].float().cpu().numpy())
            gts.append(sample.label)
            if return_preds:
                x = to_device(sample.image[None], self.device).float()
                sem = maskformer_infer(self.model, self.cfg, x, attention=self.attention)["sem_seg"]
                preds.append(sem.argmax(dim=1)[0].cpu().numpy())
        scores = np.stack(scores)
        gts = np.stack(gts)
        if return_preds:
            return scores, gts, np.stack(preds)
        return scores, gts

    def evaluate_ood(self, anomaly_score: np.ndarray, ood_gts: np.ndarray) -> Dict[str, float]:
        """Exact sklearn-equivalent metrics; returns the reference's key names."""
        return _names(exact_ood_metrics(anomaly_score.reshape(-1), ood_gts.reshape(-1)))

    # ------------------------------------------------------------------
    # streaming path: histograms on the device
    # ------------------------------------------------------------------
    def evaluate_dataset(self, dataset, upper_limit: int = 1300, score_range=None,
                         cohort: int = 1) -> Dict[str, float]:
        """Histogram-streaming evaluation: scores never leave the device at full
        resolution.

        Unbounded score functions (energy/PEBAL) stream into log-spaced
        (asinh-binned) histograms that cover all finite fp32 scores, so they
        cannot saturate.  If a custom ``score_range`` (or a bounded-score
        default) saturates anyway, or the certified quantization error is above
        tolerance, the evaluation falls back to the exact all-pixel path, with a
        warning — never silently distorted metrics.

        ``cohort`` > 1 packs that many images (+ labels) into one uint8
        host-to-device copy, scored and histogrammed on the device in one call.
        The last partial cohort is padded with all-255 (ignored) labels, so the
        metrics are exactly those of the unpadded loop."""
        transform = "asinh" if self.score_name in _UNBOUNDED and score_range is None else "linear"
        metrics = StreamingOODMetrics(score_range=score_range, transform=transform, device=self.device)
        if cohort > 1 and self.score_name is not None:
            fn = make_cohort_fn(self.cfg, self.model, self.score_name, self.smoothing,
                                metrics.bins, metrics.range, transform, self.attention)
            device = self.device

            def packed_iter():
                buf = []
                for i, sample in enumerate(dataset):
                    if i >= upper_limit:
                        break
                    buf.append(np.concatenate(
                        [sample.image.astype(np.uint8), sample.label.astype(np.uint8)[..., None]], axis=-1))
                    if len(buf) == cohort:
                        yield to_device(np.stack(buf), device)
                        buf = []
                if buf:
                    pad = buf[-1].copy()
                    pad[..., 3] = 255  # ignored everywhere
                    yield to_device(np.stack(buf + [pad] * (cohort - len(buf))), device)

            class _View:  # prefetch() wants an iterable; the uploads run in its producer
                def __iter__(self):
                    return packed_iter()

            for packed in prefetch(_View(), (upper_limit + cohort - 1) // cohort):
                dp, dn, lo, hi = fn(packed)
                metrics.absorb(dp, dn, lo, hi, int(np.prod(packed.shape[:3])))
        else:
            for sample in prefetch(dataset, upper_limit):
                s = self.score_fn(sample.image[None])
                # uint8 labels: 4x fewer bytes to upload; the histogram compares ints
                metrics.update(s[0], sample.label.astype(np.uint8))
        return self._certified_or_exact(metrics, dataset, upper_limit)

    def _certified_or_exact(self, metrics: StreamingOODMetrics, dataset, upper_limit: int,
                            what: str = "streaming result") -> Dict[str, float]:
        """The streamed metrics when they are certified; otherwise, with a warning, the
        exact all-pixel metrics of a second scoring pass."""
        clipped = metrics.clipped
        if not clipped and metrics.certified():
            return _names(metrics.compute())
        warnings.warn(
            f"{what} not certified (clipped={clipped}, observed scores [{float(metrics.smin):.3g}, "
            f"{float(metrics.smax):.3g}] vs range {metrics.range}); re-running the exact all-pixel path",
            stacklevel=3,
        )
        return self.evaluate_ood(*self.compute_anomaly_scores(dataset, upper_limit))

    def evaluate_ood_bootstrapped(self, dataset, ratio: float, trials: int,
                                  seed: int = 0) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Mean±std over random subsets; scores are computed once and resampled
        per trial."""
        scores, gts = self.compute_anomaly_scores(dataset)
        n = len(scores)
        sample_size = int(n * ratio)
        rng = np.random.RandomState(seed)
        acc: Dict[str, List[float]] = {}
        for _ in range(trials):
            idx = rng.choice(np.arange(n), sample_size, replace=False)
            m = self.evaluate_ood(scores[idx], gts[idx])
            for k, v in m.items():
                acc.setdefault(k, []).append(v)
        means = {k: float(np.mean(v) * 100.0) for k, v in acc.items()}
        stds = {k: float(np.std(v) * 100.0) for k, v in acc.items()}
        return means, stds


def evaluate_dataset_multi(evaluators: Dict[str, "OODEvaluator"], dataset,
                           upper_limit: int = 1300) -> Dict[str, Dict[str, float]]:
    """Model-fused streaming sweep: upload each image ONCE and score it with every
    model in ``evaluators`` before moving on, instead of re-reading the dataset per
    model.

    The uploads run on the prefetch thread, from pinned memory on that thread's
    current stream, to the first evaluator's device.  Returns {model_name: metrics};
    a model whose streaming histogram saturates or is not certified is re-run on the
    exact all-pixel path, as in ``evaluate_dataset``.
    """
    states = {
        name: StreamingOODMetrics(transform="asinh" if ev.score_name in _UNBOUNDED else "linear",
                                  device=ev.device)
        for name, ev in evaluators.items()
    }
    device = next(iter(evaluators.values())).device

    class _Uploaded:
        __slots__ = ("image", "label")

        def __init__(self, sample):
            self.image = to_device(sample.image[None].astype(np.uint8), device)
            self.label = to_device(sample.label.astype(np.uint8), device)

    class _View:
        def __iter__(self):
            for i, sample in enumerate(dataset):
                if i >= upper_limit:
                    break
                yield _Uploaded(sample)

    for up in prefetch(_View(), upper_limit, depth=2):
        for name, ev in evaluators.items():
            s = ev.score_fn(up.image)
            states[name].update(s[0], up.label)

    return {name: ev._certified_or_exact(states[name], dataset, upper_limit, f"streaming result for {name}")
            for name, ev in evaluators.items()}


def miou(pred: np.ndarray, gt: np.ndarray, num_classes: int, ignore: int = 255) -> float:
    """Mean IoU for the Cityscapes-style semantic evaluation."""
    valid = gt != ignore
    p = pred[valid].astype(np.int64)
    g = gt[valid].astype(np.int64)
    conf = np.bincount(g * num_classes + p, minlength=num_classes**2).reshape(num_classes, num_classes)
    inter = np.diag(conf).astype(np.float64)
    union = conf.sum(0) + conf.sum(1) - np.diag(conf)
    iou = inter / np.maximum(union, 1)
    return float(np.mean(iou[union > 0]))
