"""Exact linear-sum assignment, the plain version (counterpart of ``rba_tpu/ops/lsap.py``).

The shortest-augmenting-path (Jonker–Volgenant) solver of ``rba_tpu``, line by line,
for each (R, C) cost matrix of a batch with R <= C: the rows are taken in order; for
each, the shortest augmenting path is grown one column at a time (the least reduced
cost over unscanned columns; among equal minima the first free column, failing that
the first column), the duals ``u``, ``v`` are updated, and the path is augmented.  The
fp32 arithmetic is in ``rba_tpu``'s order.  It is the matcher's assignment where
Kernel E (``kernels/lsap.py``) does not run, the CPU's included, and the reference
that the kernel is held against, assignment for assignment.
"""
from __future__ import annotations

import torch

INF = 1e30


def _augmenting_path_step(cost, u, v, row4col, col4row, cur_row: int):
    nr, nc = cost.shape
    sc = torch.zeros(nc, dtype=torch.bool)
    sr = torch.zeros(nr, dtype=torch.bool)
    spc = torch.full((nc,), INF, dtype=torch.float32)
    path = torch.full((nc,), -1, dtype=torch.int32)
    inf = torch.tensor(INF, dtype=torch.float32)
    sink, i, min_val = -1, cur_row, torch.tensor(0.0, dtype=torch.float32)
    while sink < 0:
        linear_sum_assignment.steps += 1
        sr[i] = True
        reduced = min_val + cost[i] - u[i] - v  # (C,)
        better = (reduced < spc) & ~sc
        spc = torch.where(better, reduced, spc)
        path = torch.where(better, torch.tensor(i, dtype=torch.int32), path)
        # the lowest-cost unscanned column, free columns first on ties
        masked = torch.where(sc, inf, spc)
        m = masked.min()
        cand = masked == m
        free_cand = cand & (row4col < 0)
        j = int(torch.argmax(free_cand.int() if bool(free_cand.any()) else cand.int()))
        min_val = m
        if int(row4col[j]) < 0:
            sink = j
        else:
            i = int(row4col[j])
        sc[j] = True

    # dual updates
    u[cur_row] = u[cur_row] + min_val
    other = sr & (torch.arange(nr) != cur_row)
    u = torch.where(other, u + min_val - spc[col4row.clamp(0, nc - 1).long()], u)
    v = torch.where(sc, v - (min_val - spc), v)

    # augment: walk back along the path
    j = sink
    while True:
        i = int(path[j])
        row4col[j] = i
        prev = int(col4row[i])
        col4row[i] = j
        j = prev
        if i == cur_row:
            break
    return u, v, row4col, col4row


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """(R, C) cost, R <= C → (R,) int32 assigned column of each row (exact)."""
    nr, nc = cost.shape
    if nr > nc:
        raise ValueError(f"linear_sum_assignment needs rows <= columns, got {nr} x {nc}")
    cost = cost.detach().to("cpu", torch.float32)
    u = torch.zeros(nr, dtype=torch.float32)
    v = torch.zeros(nc, dtype=torch.float32)
    row4col = torch.full((nc,), -1, dtype=torch.int32)
    col4row = torch.full((nr,), -1, dtype=torch.int32)
    for r in range(nr):
        u, v, row4col, col4row = _augmenting_path_step(cost, u, v, row4col, col4row, r)
    return col4row


linear_sum_assignment.steps = 0  # column scans (steps of the augmenting paths) since the last reset


def batched_linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """(B, R, C) cost → (B, R) int32 col4row, one matrix at a time, on the CPU; the result
    goes back to the cost's device."""
    if cost.dim() != 3:
        raise ValueError(f"cost must be (B, R, C), got {tuple(cost.shape)}")
    out = torch.stack([linear_sum_assignment(c) for c in cost.detach().cpu()]) if cost.shape[0] else \
        torch.zeros(0, cost.shape[1], dtype=torch.int32)
    return out.to(cost.device)
