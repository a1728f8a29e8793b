"""Process groups and the 2-D ``("data", "model")`` mesh (counterpart of ``rba_tpu/parallel/mesh.py``).

``rba_tpu`` lays a ``data`` axis and a ``model`` axis over its devices and lets XLA
derive the collectives from the shardings.  The port runs one process per GPU (one rank
of a ``torch.distributed`` group), so the mesh is a grid of ranks with a subgroup per
row and per column, and every collective is written out: the batch is split over
``data`` (``shard_batch``), the losses' batch sums and the gradients are all-reduced
over ``data`` (``train/criterion.py``, ``train/train_step.py``), and the MLP weights
split over ``model`` (``parallel/tp.py``).  Ranks are laid out as ``rba_tpu`` lays out
its devices, ``reshape(n // model_axis, model_axis)``: the ranks of one model group are
consecutive.

``init_distributed`` joins the group that torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``...) or a launcher's arguments describe, or forms a
1-rank group of its own: NCCL on the card, gloo on the CPU.  Nothing falls back to
another backend or to running alone when a group fails to form.

``COUNTS`` counts the all-reduces that the port makes, by kind (``"loss"``: a batch
sum of the criterion; ``"grad"``: a gradient bucket; ``"model"``: a tensor-parallel
partial sum), so a run can check how many it made.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

COUNTS: Dict[str, int] = {"loss": 0, "grad": 0, "model": 0}

# a rank that waits longer than this on a collective raises instead of hanging
DEFAULT_TIMEOUT_S = 600


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", rank: Optional[int] = None, world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> int:
    """Join the process group, or form it, and return this rank.

    An already formed group is kept.  Otherwise rank, world size and rendezvous come
    from the arguments (a launcher's ``init_method`` such as ``file://...`` or
    ``tcp://localhost:port``), else from torchrun's environment (``env://``), else this
    process forms a 1-rank group on an in-process store.  The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU; a CUDA ``device`` without a GPU raises.  On
    the card the rank's GPU is ``LOCAL_RANK`` (or the rank) and becomes the current
    device."""
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the process group runs on the GPU by default and none is available; "
                           "pass device='cpu' to form a gloo group on the CPU")
    backend = backend_for(device)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    store = None
    if rank is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if rank is None:
        rank, world_size, store = 0, 1, dist.HashStore()
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device, rank))
    kw: Dict[str, Any] = dict(backend=backend, rank=rank, world_size=world_size, timeout=timeout)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    if device.type == "cuda":
        kw["device_id"] = local_device(device, rank)
    dist.init_process_group(**kw)
    return rank


def local_device(device, rank: Optional[int] = None) -> torch.device:
    """This rank's device: on the card ``cuda:LOCAL_RANK`` (torchrun's), else
    ``cuda:rank``; a CPU device as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


@dataclass
class Mesh:
    """A (data, model) grid of the group's ranks and this rank's place in it."""

    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    data_group: Any  # this rank's column: the ranks that hold the same model shard
    model_group: Any  # this rank's row: the ranks that hold the same batch rows


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1, device="cuda") -> Mesh:
    """The ``("data", "model")`` mesh over the process group, which is joined or formed
    first on ``device`` (``init_distributed``: the card unless the caller asks for the
    CPU): ``n_devices`` ranks (default: the world size) as ``(n // model_axis,
    model_axis)``.  Every rank calls it, in the same order as every other collective."""
    if not dist.is_initialized():
        init_distributed(device)
    world = dist.get_world_size()
    n = n_devices or world
    if n % model_axis:
        raise ValueError(f"n_devices={n} is not divisible by model_axis={model_axis}; "
                         f"pick a model axis that divides the device count")
    if n != world:
        raise ValueError(f"n_devices={n}: the mesh spans the whole group of {world} ranks")
    rank = dist.get_rank()
    d, m = n // model_axis, model_axis
    grid = [[i * m + j for j in range(m)] for i in range(d)]
    data_group = model_group = None
    # every rank creates every subgroup, in one order (torch.distributed.new_group's rule)
    for j in range(m):
        ranks = [grid[i][j] for i in range(d)]
        g = dist.new_group(ranks)
        if rank in ranks:
            data_group = g
    for i in range(d):
        g = dist.new_group(grid[i])
        if rank in grid[i]:
            model_group = g
    return Mesh(data_size=d, model_size=m, data_rank=rank // m, model_rank=rank % m, data_group=data_group,
                model_group=model_group)


def data_rows(n: int, data_rank: int, data_size: int, micro: int = 1) -> List[int]:
    """The rows of a global batch of ``n`` that data rank ``data_rank`` holds: dim 0 split
    over ``data`` as ``P("data")`` splits it.  With ``micro`` > 1 the global batch is
    ``micro`` consecutive micro-batches and the rank holds its share of each, in order,
    so that its k-th local micro-batch is its share of the k-th global one."""
    if n % (data_size * micro):
        raise ValueError(f"a global batch of {n} does not split over {data_size} data rank(s) x {micro} "
                         "micro-batch(es)")
    size, share = n // micro, n // (micro * data_size)
    return [k * size + data_rank * share + j for k in range(micro) for j in range(share)]


def shard_batch(mesh: Mesh, batch: Dict[str, Any], micro: int = 1) -> Dict[str, Any]:
    """This data rank's rows (``data_rows``) of every leaf of a global batch (numpy
    arrays or tensors, dim 0 the batch)."""
    n = next(iter(batch.values())).shape[0]
    rows = data_rows(n, mesh.data_rank, mesh.data_size, micro)
    return {k: v[rows] if not isinstance(v, torch.Tensor) else v[torch.as_tensor(rows, device=v.device)]
            for k, v in batch.items()}


class _SumAcrossRanks(torch.autograd.Function):
    """All-reduce (sum) of a tensor whose consumers run the same on every rank of the
    group: the backward is the identity.  Every rank then holds the same total and the
    same loss built from it, so the gradient that reaches each rank's partial sum is
    the loss's gradient with respect to the total, and the data-parallel gradient
    all-reduce adds the ranks' parts into the global gradient.  (Megatron's ``g``.)"""

    @staticmethod
    def forward(ctx, x, group, kind):
        y = x.clone()
        dist.all_reduce(y, group=group)
        COUNTS[kind] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToRanks(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the group.  It
    stands before a column-parallel layer, whose ranks each see a part of the input's
    gradient.  (Megatron's ``f``.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        COUNTS["model"] += 1
        return g, None


def sum_across(x: torch.Tensor, group, kind: str = "loss") -> torch.Tensor:
    """``x`` summed over ``group``, with the identity as its gradient (``_SumAcrossRanks``)."""
    return _SumAcrossRanks.apply(x, group, kind)


def copy_to_ranks(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToRanks.apply(x, group)


def global_sums(group, *sums: torch.Tensor) -> Sequence[torch.Tensor]:
    """Each 0-dim ``sums`` entry summed over ``group`` in one all-reduce; the entries
    themselves where ``group`` is None (one process, no group)."""
    if group is None:
        return sums
    total = sum_across(torch.stack([s.float() for s in sums]), group)
    return tuple(total[i] for i in range(len(sums)))
