"""Tensor parallelism of the transformer MLPs over the mesh's ``model`` axis
(counterpart of ``rba_tpu/parallel/tp.py``).

The rules are ``rba_tpu``'s, by module name:

* ``fc1`` and ``linear1`` are column-parallel: each model rank keeps a slice of the
  output (hidden) dim of the weight and its bias, so the activation between the two
  layers stays local;
* ``fc2`` and ``linear2`` are row-parallel: each rank keeps the matching slice of the
  input dim, and its product is a partial sum;
* a layer is split only where its hidden dim divides by the axis size; everything else
  is replicated, and a warning says so when nothing matched.

``rba_tpu`` lets GSPMD derive the collectives from these layouts.  Here they are written
out, as Megatron writes them: the input of a column-parallel layer passes through
``copy_to_ranks`` (identity forward, gradient all-reduced over ``model``); the
row-parallel partial sums are all-reduced over ``model`` (``sum_across``, identity
backward) and the bias is added once, after that sum.  So every rank's replicated
parameters receive the whole gradient, and the sharded ones their slice of it; the
optimizer built after ``shard_params_tp`` keeps AdamW's moments in the shards' shapes,
and ``grad_norm_tp`` sums the shards' squares over ``model`` and the replicated ones
once, for the clip.

Kernel D (``mlp_impl="fused"``, inference) reads fc1 and fc2 whole: ``rba_tpu``'s
``pallas_call`` is not partitioned by GSPMD, which gathers its operands whole, so the
port gathers the shards (``full_linear``) and runs the kernel on the whole weights.

MiT's Mix-FFN runs a depthwise conv between its ``fc1`` and ``fc2``; that pair stays
replicated (a sharded hidden would need the conv sharded too).
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.nn import linear
from .mesh import Mesh, copy_to_ranks, sum_across

_COLUMN = ("fc1", "linear1")  # shard the output dim
_ROW = ("fc2", "linear2")  # shard the input dim


class ShardedLinear:
    """A linear layer's place in the model axis: ``kind`` "column" or "row", and the
    group of ranks that hold its other slices."""

    def __init__(self, kind: str, group, size: int):
        self.kind, self.group, self.size = kind, group, size

    def apply(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "column":
            return linear(copy_to_ranks(x, self.group), layer.weight, layer.bias)
        y = sum_across(F.linear(x, layer.weight.to(x.dtype)), self.group, kind="model")
        return y if layer.bias is None else y + layer.bias.to(y.dtype)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


def tp_kind(name: str, weight_shape, model_size: int) -> Optional[str]:
    """"column", "row" or None (replicated) for the linear layer ``name`` with a
    (out, in) weight of ``weight_shape``: ``rba_tpu``'s ``tp_spec`` in torch's layout."""
    if model_size <= 1 or len(weight_shape) != 2:
        return None
    leaf = name.rpartition(".")[2]
    if leaf in _COLUMN and weight_shape[0] % model_size == 0:
        return "column"
    if leaf in _ROW and weight_shape[1] % model_size == 0:
        return "row"
    return None


def _pairs(model: nn.Module):
    """(name, layer) of the linear layers that the rules may shard: both layers of a pair
    are split, or neither (a hidden dim that divides for one divides for the other)."""
    mods = dict(model.named_modules())
    for name, mod in mods.items():
        if not isinstance(mod, nn.Linear):
            continue
        parent, _, leaf = name.rpartition(".")
        if leaf not in _COLUMN + _ROW:
            continue
        siblings = dict(mods[parent].named_children()) if parent in mods else {}
        if "dwconv" in siblings:
            continue  # MiT's Mix-FFN
        yield name, mod


def shard_params_tp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's slice of each matched MLP weight, in place, and mark the layer
    (``ShardedLinear``).  Build the optimizer after this.  Warns, as ``rba_tpu`` does, when a
    model axis > 1 matched nothing."""
    m = mesh.model_size
    n_sharded = 0
    with torch.no_grad():
        for name, layer in _pairs(model):
            kind = tp_kind(name, tuple(layer.weight.shape), m)
            if kind is None:
                continue
            r = mesh.model_rank
            if kind == "column":
                h = layer.weight.shape[0] // m
                layer.weight.data = layer.weight.data[r * h : (r + 1) * h].clone()
                if layer.bias is not None:
                    layer.bias.data = layer.bias.data[r * h : (r + 1) * h].clone()
            else:
                h = layer.weight.shape[1] // m
                layer.weight.data = layer.weight.data[:, r * h : (r + 1) * h].clone()
            layer.tp = ShardedLinear(kind, mesh.model_group, m)
            n_sharded += 1
    if m > 1 and n_sharded == 0:
        warnings.warn(f"shard_params_tp: model axis size {m} requested but no parameter matched the TP rules "
                      f"(MLP dims must be divisible by {m}); the model is fully replicated — no tensor "
                      "parallelism", stacklevel=2)
    return model


def is_sharded(p_name: str, model: nn.Module) -> bool:
    mod = model.get_submodule(p_name.rpartition(".")[0])
    tp = getattr(mod, "tp", None)
    return tp is not None and (p_name.endswith(".weight") or tp.kind == "column")


def full_linear(layer: nn.Linear) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's whole (out, in) weight and bias: the slices all-gathered over the model
    axis where the layer is sharded (no gradient flows through the gather)."""
    tp = getattr(layer, "tp", None)
    if tp is None:
        return layer.weight, layer.bias
    with torch.no_grad():
        if tp.kind == "column":
            bias = None if layer.bias is None else tp.gather(layer.bias, 0)
            return tp.gather(layer.weight, 0), bias
        return tp.gather(layer.weight, 1), layer.bias


def grad_norm_tp(model: nn.Module, mesh: Mesh) -> torch.Tensor:
    """The global gradient norm of a tensor-parallel model: the sharded gradients' squares
    summed over ``model``, the replicated ones counted once."""
    rep, shard = [], []
    for name, p in model.named_parameters():
        (shard if is_sharded(name, model) else rep).append(p.grad.float().square().sum())
    zero = torch.zeros((), device=next(model.parameters()).device)
    s = torch.stack(shard).sum() if shard else zero
    s = sum_across(s, mesh.model_group, kind="model")
    return torch.sqrt((torch.stack(rep).sum() if rep else zero) + s)
