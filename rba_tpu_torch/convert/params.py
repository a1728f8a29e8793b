"""The JAX package's parameter pytree: into the port's model, and to and from ``params.npz``.

The port's parameter names are the pytree paths, so the mapping is mechanical:
a leaf ``kernel`` becomes ``weight`` (a linear's (in, out) transposed to
(out, in); an HWIO conv kernel to OIHW), a norm's ``scale`` becomes
``weight``, ``bias`` stays, and any other leaf (bias tables, embeddings, a batch
norm's ``mean`` and ``var``) keeps its name.  Leaves may be numpy arrays or anything
``np.asarray`` takes.

``params.npz`` is the JAX package's flat file: one array per leaf, keyed by the
leaf's path joined with ``|`` (dict keys, list indices).  ``save_params`` writes it
as the JAX package does, so each package reads the other's file.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf, in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def jax_params_to_state(params: Any) -> Dict[str, np.ndarray]:
    """The pytree as {torch parameter name: array in the torch layout}."""
    state = {}
    for parts, leaf in _leaves(params):
        arr = np.asarray(leaf)
        path = ".".join(parts)
        head, _, leaf_name = path.rpartition(".")
        name = f"{head}.{_LEAF_NAMES[leaf_name]}" if head and leaf_name in _LEAF_NAMES else path
        if leaf_name == "kernel":
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


_SEP = "|"  # the path separator of the JAX package's params.npz keys


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v

    # convert {"0": .., "1": ..} dicts into lists
    def listify(node):
        if isinstance(node, dict):
            node = {k: listify(v) for k, v in node.items()}
            if node and all(k.isdigit() for k in node):
                return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_params(path: str, params: Any) -> None:
    """Write the pytree as a flat ``params.npz``."""
    np.savez(path, **{_SEP.join(parts): np.asarray(leaf) for parts, leaf in _leaves(params)})


def load_params(path: str):
    """The parameter pytree stored in a flat ``params.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})
