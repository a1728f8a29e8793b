"""Detectron2 checkpoint files: readers, conversion and the model of a model directory
(counterpart of ``rba_tpu/convert/checkpoint.py``).

A released checkpoint is a torch ``.pth`` zip (a state dict, possibly under
``"model"`` or ``"state_dict"``, beside metadata) or a Detectron2 ``.pkl`` pickle of
numpy arrays.  ``load_checkpoint_params`` builds the model of a model directory from
its ``params.npz`` or, where there is none, converts its ``model_final.pth``/``.pkl``
and writes the ``params.npz`` beside it, as ``rba_tpu`` does.
"""
from __future__ import annotations

import os
import pickle
import uuid
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .params import load_jax_params, load_params, save_params


def read_d2_pickle(path: str) -> Dict[str, np.ndarray]:
    """A Detectron2 ``.pkl``: a plain pickle of {"model": {name: ndarray}, ...}."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    model = data.get("model", data)
    return {k: np.asarray(v) for k, v in model.items() if isinstance(v, np.ndarray)}


def read_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The tensors and numpy arrays of a torch ``.pth`` checkpoint, as numpy arrays.

    Read with ``weights_only=False``, as ``rba_tpu`` reads it: a Detectron2 checkpoint
    may hold numpy arrays and non-tensor metadata beside the weights, which the
    weights-only unpickler refuses.  Unpickling runs code, so load only checkpoint
    files from a source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        elif isinstance(v, np.ndarray):
            out[k] = v
    return out


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".pkl"):
        return read_d2_pickle(path)
    return read_torch_checkpoint(path)


def convert_d2_checkpoint(ckpt_path: str, cfg, out_path: Optional[str] = None):
    """D2 checkpoint file → parameter pytree (written to ``out_path`` as a ``params.npz``
    when given)."""
    from .d2_mapping import convert_d2_state_dict

    params = convert_d2_state_dict(read_state_dict(ckpt_path), cfg)
    if out_path:
        save_params(out_path, params)
    return params


def _write_cache(npz: str, params) -> None:
    """Write ``params.npz`` whole or not at all: into a file of its own beside it, renamed
    onto it when complete, so that a reader (another ``--shard`` of the sweep) never sees
    it part-written.  A directory that cannot be written is left without a cache."""
    tmp = f"{npz}.{uuid.uuid4().hex}.tmp.npz"
    try:
        save_params(tmp, params)
        os.replace(tmp, npz)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def load_checkpoint_params(model_dir: str, cfg, device=None) -> nn.Module:
    """The model of ``cfg`` on ``device`` (the card by default, as ``build_model``)
    holding the weights of ``model_dir``: its ``params.npz`` or, where there is none, its
    Detectron2 ``model_final.pth``/``.pkl``, converted, with the ``params.npz`` written
    beside it as a cache (a directory that cannot be written is left without one)."""
    from ..models.maskformer import build_model, resolve_device

    device = resolve_device(device, "load_checkpoint_params")
    npz = os.path.join(model_dir, "params.npz")
    if os.path.exists(npz):
        params = load_params(npz)
    else:
        for cand in ("model_final.pth", "model_final.pkl"):
            p = os.path.join(model_dir, cand)
            if os.path.exists(p):
                params = convert_d2_checkpoint(p, cfg)
                _write_cache(npz, params)
                break
        else:
            raise FileNotFoundError(f"no checkpoint (params.npz / model_final.pth) in {model_dir}")
    return load_jax_params(build_model(cfg, device=device), params)
