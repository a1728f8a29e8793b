"""The system under test: the PyTorch/CUDA port, driven through its public entry points.

Only this module imports the port.  It builds the port's model from the configuration
file and the benchmark's weights, serves a request through
``models.maskformer.maskformer_infer_rba`` and evaluates through
``evalx.evaluator.OODEvaluator.evaluate_dataset``."""
from __future__ import annotations

from typing import Callable, Dict

import torch

LAYERS_SPANS = ("preprocess", "backbone", "pixel_decoder", "transformer_decoder", "rba_tail")  # the entry's spans


def build_kernels(device) -> None:
    """Build (or find built) the port's CUDA kernels, in parallel, before the first request."""
    if torch.device(device).type == "cuda":
        from rba_tpu_torch.kernels import _build

        _build.build_all()


def parameter_shapes(model: dict) -> Dict[str, tuple]:
    """The port's parameters by name and shape, for the configuration's ``model`` object."""
    from rba_tpu_torch.config import config_from_dict
    from rba_tpu_torch.models.maskformer import RbAModel

    with torch.device("meta"):
        net = RbAModel(config_from_dict(model))
    return {name: tuple(p.shape) for name, p in net.state_dict().items()}


def build(model: dict, weights: Dict[str, torch.Tensor]):
    """(the port's config, its model holding ``weights``)."""
    from rba_tpu_torch.config import config_from_dict
    from rba_tpu_torch.models.maskformer import RbAModel

    cfg = config_from_dict(model)
    with torch.device("meta"):
        net = RbAModel(cfg)
    net.load_state_dict(weights, strict=True, assign=True)
    return cfg, net.eval()


def serve_fn(cfg, net, attention: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """One request: (B, H, W, 3) uint8 frames in host memory → (B, H, W) fp32 score maps
    in host memory."""
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    def serve(frames: torch.Tensor) -> torch.Tensor:
        return maskformer_infer_rba(net, cfg, frames, attention=attention).cpu()

    return serve


def evaluate_fn(cfg, net, traffic: dict) -> Callable:
    """One evaluation pass over a dataset → {"auroc", "aupr", "fpr95"}."""
    from rba_tpu_torch.evalx.evaluator import OODEvaluator

    ev = OODEvaluator(cfg, net, score=traffic["score"], attention=traffic["attention"])

    def evaluate(dataset, limit: int = 1300) -> Dict[str, float]:
        return ev.evaluate_dataset(dataset, upper_limit=limit, cohort=traffic["cohort"])

    return evaluate
