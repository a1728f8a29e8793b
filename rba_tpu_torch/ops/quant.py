"""Weight-only int8 serving (counterpart of ``rba_tpu/ops/quant.py``).

Symmetric per-output-channel int8 for 2-D linear weights: an eligible layer gives up
its ``weight`` for two buffers, ``kernel_q`` (int8, the (out, in) layout of the weight)
and ``kscale`` (fp32, (out,)), and keeps its bias.  ``ops.nn.apply_linear``
dequantizes as ``rba_tpu``'s ``linear`` does, ``kernel_q.to(x.dtype) * kscale.to(x.dtype)``,
then takes the product, so at bf16 the dequantized weight is rounded as there.

The rules are ``rba_tpu``'s, stated on its parameter tree, whose paths are the port's
module names (``convert/params.py``): a layer is quantized where its parameters are a
2-D weight and at most a bias, both of its dims are >= ``min_dim``, and its name (the
last part of its path that is not a list index) is not one that some code reads raw:
``in_proj`` (the decoder's packed attention projection) and ``patch_embed``, and per
config MViT's ``proj`` and, under ``mlp_impl="fused"``, Swin's ``fc1`` and ``fc2``,
whose whole weights Kernel D reads.
"""
from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

# layers whose weights some code reads raw, never quantized
_SKIP_NAMES = frozenset({"in_proj", "patch_embed"})


def config_skip_names(cfg) -> frozenset:
    """The config's raw-weight readers: MViT's pooling-attention ``proj`` and, under
    ``mlp_impl="fused"``, the fc1/fc2 that Kernel D reads."""
    extra = set()
    if cfg is None:
        return frozenset()
    if getattr(cfg, "backbone_name", "") == "mvit":
        extra.add("proj")
    swin = getattr(cfg, "swin", None)
    if swin is not None and getattr(swin, "mlp_impl", "xla") == "fused":
        extra.update(("fc1", "fc2"))
    return frozenset(extra)


def quantize_linear_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel_q int8 (out, in), kscale fp32 (out,)) of one (out, in) weight: ``rba_tpu``'s
    arithmetic on its (in, out) kernel, in numpy, so the two agree bit for bit."""
    k = weight.detach().cpu().numpy().astype(np.float32).T  # (din, dout)
    amax = np.abs(k).max(axis=0)  # (dout,)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(k / scale), -127, 127).astype(np.int8)
    return (torch.from_numpy(np.ascontiguousarray(q.T)).to(weight.device),
            torch.from_numpy(scale).to(weight.device))


def _tree_name(module_name: str) -> str:
    """The name ``rba_tpu``'s walk gives a layer: its key, or its list's key."""
    parts = [p for p in module_name.split(".") if not p.isdigit()]
    return parts[-1] if parts else ""


def eligible(name: str, module: nn.Module, min_dim: int, skip: frozenset) -> bool:
    own = dict(module.named_parameters(recurse=False))
    w = own.get("weight")
    nested = any(True for c in module.children() for _ in c.parameters())  # a subtree in rba_tpu's dict
    return (w is not None and set(own) <= {"weight", "bias"} and not nested and w.dim() == 2
            and min(w.shape) >= min_dim and _tree_name(name) not in skip)


def set_quantized(module: nn.Module, kernel_q: torch.Tensor, kscale: torch.Tensor) -> None:
    """Swap the layer's weight for its int8 buffers."""
    del module.weight
    module.register_buffer("kernel_q", kernel_q)
    module.register_buffer("kscale", kscale)


def quantize_params_int8(model: nn.Module, min_dim: int = 64, cfg=None) -> nn.Module:
    """A copy of ``model`` with every eligible linear weight in int8.  Pass ``cfg`` so
    the config's raw-weight readers are skipped."""
    model = copy.deepcopy(model)
    skip = _SKIP_NAMES | config_skip_names(cfg)
    for name, mod in list(model.named_modules()):
        if eligible(name, mod, min_dim, skip):
            set_quantized(mod, *quantize_linear_int8(mod.weight))
    return model


def is_quantized(model: nn.Module) -> bool:
    return any(hasattr(m, "kernel_q") for m in model.modules())


def count_quantized(model: nn.Module) -> Dict[str, int]:
    """{"quantized": n layers, "int8_params": n, "fp_linear": n 2-D weights left in fp}."""
    stats = {"quantized": 0, "int8_params": 0, "fp_linear": 0}
    for mod in model.modules():
        if hasattr(mod, "kernel_q"):
            stats["quantized"] += 1
            stats["int8_params"] += mod.kernel_q.numel()
        else:
            w = dict(mod.named_parameters(recurse=False)).get("weight")
            if w is not None and w.dim() == 2:
                stats["fp_linear"] += 1
    return stats


def weight_bytes(model: nn.Module) -> int:
    """Bytes of the model's parameters and int8 buffers."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    return n + sum(b.numel() * b.element_size() for name, b in model.named_buffers()
                   if name.endswith(("kernel_q", "kscale")))
