"""Load the JAX package's parameter pytree into the port's model.

The port's parameter names are the pytree paths, so the mapping is mechanical:
a leaf ``kernel`` becomes ``weight`` (a linear's (in, out) transposed to
(out, in); an HWIO conv kernel to OIHW), a norm's ``scale`` becomes
``weight``, ``bias`` stays, and any other leaf (bias tables, embeddings) keeps
its name.  Leaves may be numpy arrays or anything ``np.asarray`` takes.

``load_params`` reads the pytree from the JAX package's flat ``params.npz``
(``|``-joined paths), and ``load_checkpoint_params`` builds a model from a model
directory that holds one.
"""
from __future__ import annotations

import os
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


def load_params(path: str):
    """The parameter pytree stored in a flat ``params.npz`` of the JAX package."""
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def load_checkpoint_params(model_dir: str, cfg, device=None) -> nn.Module:
    """The model of ``cfg`` on ``device`` (the card by default, as ``build_model``)
    holding the weights of ``model_dir/params.npz``.  Released Detectron2 checkpoints
    (``model_final.pth`` / ``.pkl``) need the Detectron2 loader, which the port does
    not have yet."""
    from .models.maskformer import build_model

    npz = os.path.join(model_dir, "params.npz")
    if os.path.exists(npz):
        return load_jax_params(build_model(cfg, device=device), load_params(npz))
    for cand in ("model_final.pth", "model_final.pkl"):
        if os.path.exists(os.path.join(model_dir, cand)):
            raise NotImplementedError(
                f"{model_dir} holds {cand} and no params.npz: the Detectron2 checkpoint loader is not "
                "ported yet (ROADMAP.md A.1); convert it to params.npz with the JAX package")
    raise FileNotFoundError(f"no checkpoint (params.npz / model_final.pth) in {model_dir}")
