"""The JAX package's parameter pytree: into the port's model, and to and from ``params.npz``.

The port's parameter names are the pytree paths, so the mapping is mechanical:
a leaf ``kernel`` becomes ``weight`` (a linear's (in, out) transposed to
(out, in); an HWIO conv kernel to OIHW), a norm's ``scale`` becomes
``weight``, ``bias`` stays, and any other leaf (bias and position tables,
embeddings, a batch norm's ``mean`` and ``var``) keeps its name.  Leaves may be numpy
arrays or anything ``np.asarray`` takes.  A number of rank 0 in the tree (the
SimpleFeaturePyramid's scale of each stage) is configuration, not a parameter: the
model holds it, and ``model_to_jax_params`` puts it back (a module's
``jax_constants()``).

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
        if arr.ndim == 0:
            continue
        path = ".".join(parts)
        head, _, leaf_name = path.rpartition(".")
        name = f"{head}.{_LEAF_NAMES[leaf_name]}" if head and leaf_name in _LEAF_NAMES else path
        if leaf_name == "kernel_q":  # an int8 linear (ops/quant.py): (in, out) -> (out, in)
            arr = arr.T
        if leaf_name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{path}: a kernel of rank {arr.ndim}")
        state[name] = arr
    return state


# relative-position tables, which the models resample to any size: a checkpoint's may
# have another length than the config's (ViTDet stores them at its input grid)
_RESIZABLE = ("rel_pos_h", "rel_pos_w")


def load_jax_params(model: nn.Module, params: Any) -> nn.Module:
    """Copy the JAX pytree into ``model``'s parameters; raise on any missing or
    unexpected name and on any shape that differs, but for a relative-position table of
    another length, which takes the pytree's."""
    state = jax_params_to_state(params)
    for name in state:
        if name.endswith(".kernel_q"):  # a quantized tree: the layer takes int8 buffers first
            mod = model.get_submodule(name[: -len(".kernel_q")])
            if not hasattr(mod, "kernel_q"):
                from ..ops.quant import set_quantized

                shape = state[name].shape
                set_quantized(mod, torch.zeros(shape, dtype=torch.int8, device=mod.weight.device),
                              torch.zeros(shape[0], device=mod.weight.device))
    own = dict(model.named_parameters())
    own.update((n, b) for n, b in model.named_buffers() if n.endswith((".kernel_q", ".kscale")))
    missing = sorted(own.keys() - state.keys())
    unexpected = sorted(state.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(f"parameters missing from the pytree: {missing}; not in the model: {unexpected}")
    with torch.no_grad():
        for name, p in own.items():
            arr = state[name]
            if name.endswith(_RESIZABLE) and arr.shape[1:] == tuple(p.shape[1:]) and arr.shape[0] != p.shape[0]:
                mod_name, _, leaf = name.rpartition(".")
                p = nn.Parameter(torch.empty(arr.shape, dtype=p.dtype, device=p.device))
                setattr(model.get_submodule(mod_name), leaf, p)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: pytree shape {tuple(arr.shape)}, model shape {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=p.dtype if p.dtype == torch.int8 else torch.float32))
    return model


def jax_path(name: str, ndim: int) -> str:
    """The pytree path, joined with ``/``, of the port parameter ``name`` of rank ``ndim``:
    the inverse of ``jax_params_to_state``'s naming (a ``weight`` of rank 2 or 4 is a
    ``kernel``, of rank 1 a norm's ``scale``)."""
    head, _, leaf = name.rpartition(".")
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "/".join(head.split(".") + [leaf]) if head else leaf


def model_to_jax_params(model: nn.Module):
    """The model's parameters as the JAX package's pytree of numpy arrays (nested dicts,
    lists where the keys are indices), in its layouts: the inverse of ``load_jax_params``."""
    flat = {}
    for name, p in model.named_parameters():
        arr = p.detach().cpu().numpy()
        if name.endswith(".weight") and arr.ndim == 2:
            arr = arr.T
        elif name.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat[jax_path(name, arr.ndim).replace("/", _SEP)] = np.ascontiguousarray(arr)
    for name, b in model.named_buffers():  # int8 linears: kernel_q back to (in, out), kscale
        if name.endswith((".kernel_q", ".kscale")):
            arr = b.detach().cpu().numpy()
            flat[name.replace(".", _SEP)] = np.ascontiguousarray(arr.T if arr.ndim == 2 else arr)
    for name, mod in model.named_modules():
        if hasattr(mod, "jax_constants"):
            for parts, value in _leaves(mod.jax_constants(), tuple(name.split(".")) if name else ()):
                flat[_SEP.join(parts)] = value
    return _unflatten(flat)


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
