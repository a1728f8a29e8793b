"""Load the JAX package's parameter pytree into the port's model.

The port's parameter names are the pytree paths, so the mapping is mechanical:
a leaf ``kernel`` becomes ``weight`` (a linear's (in, out) transposed to
(out, in); an HWIO conv kernel to OIHW), a norm's ``scale`` becomes
``weight``, ``bias`` stays, and any other leaf (bias tables, embeddings) keeps
its name.  Leaves may be numpy arrays or anything ``np.asarray`` takes.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], np.asarray(tree)


def jax_params_to_state(params: Any) -> Dict[str, np.ndarray]:
    """The pytree as {torch parameter name: array in the torch layout}."""
    state = {}
    for path, arr in _flatten(params):
        head, _, leaf = path.rpartition(".")
        name = f"{head}.{_LEAF_NAMES[leaf]}" if head and leaf in _LEAF_NAMES else path
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{path}: a kernel of rank {arr.ndim}")
        state[name] = arr
    return state


def load_jax_params(model: nn.Module, params: Any) -> nn.Module:
    """Copy the JAX pytree into ``model``'s parameters; raise on any missing or
    unexpected name and on any shape that differs."""
    state = jax_params_to_state(params)
    own = dict(model.named_parameters())
    missing = sorted(own.keys() - state.keys())
    unexpected = sorted(state.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(f"parameters missing from the pytree: {missing}; not in the model: {unexpected}")
    with torch.no_grad():
        for name, p in own.items():
            arr = state[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: pytree shape {tuple(arr.shape)}, model shape {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=torch.float32))
    return model
