"""Multi-scale deformable attention sampling, forward (counterpart of ``rba_tpu/ops/deform_sampling.py``).

For each (batch, query, head, level, point) the per-head value map is sampled
bilinearly at ``loc * (W, H) - 0.5`` with zero padding outside the map,
weighted by the softmaxed attention weight, and summed over levels x points.
Plain PyTorch, in fp32, one of two forms per level:

- the gather: four integer gathers and a weighted sum;
- the one-hot form (``sampling_dtype="bfloat16"``, ``fast_serving``): the 4P corner
  weights of each query summed into a dense row of A (N, M, Lq, HW) in fp32, in
  ``rba_tpu``'s corner order; A and the values rounded to bf16 once; A·V summed in
  fp32.  What is rounded is each pixel's sum of weights, so where two points of one
  query share a pixel this differs from a gather whose weights are rounded one by one.

Gradients have the semantics of ``rba_tpu``'s custom VJPs: the gather's is autograd of
the gather (``rba_tpu`` pins its own equal to it); the one-hot form is ``OneHotLevel``,
whose backward rebuilds the row matrix in fp32 instead of saving it.  Each call runs in
the ``SPAN`` span (``utils/profiling.py``); under autograd its backward runs in
``BACKWARD_SPAN``, from the output's gradient to the inputs' (a profile reads what the
training step's sampling costs from the two).

``method="auto"`` picks the one-hot form for a level where N·M·Lq·H·W <= the cap, as
``rba_tpu`` does.  In fp32 the one-hot form computes the gather's sums (``rba_tpu``
contracts it at HIGHEST precision), so fp32 levels take the gather.

On the card a call whose every level is a gather, whose gradient autograd does not
need and whose shapes the kernel is built for runs Kernel F
(``kernels/ms_deform_attn.py``), the gather of all levels in one launch (that module's
``takes``); the plain gather above stays for the CPU, for training, for other shapes and
under ``kernels.plain_versions()``, and the bf16 one-hot form keeps its own path.
"""
from __future__ import annotations

from typing import Collection, Sequence, Tuple

import torch

from ..kernels import ms_deform_attn as kernel
from ..utils import profiling

SPAN = profiling.DEFORM_SAMPLING  # the span of each ms_deform_attn_core call
BACKWARD_SPAN = profiling.DEFORM_SAMPLING_BACKWARD  # and of its backward, where autograd runs one
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)


def _sample_level(
    value: torch.Tensor,  # (N, H, W, M, D) fp32
    loc: torch.Tensor,  # (N, Lq, M, P, 2) fp32, (x, y) in [0, 1]
    attn: torch.Tensor,  # (N, Lq, M, P) fp32
) -> torch.Tensor:  # (N, Lq, M, D)
    n, h, w, m, d = value.shape
    _, lq, _, p, _ = loc.shape
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx, ty = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    # (N·M, HW, D): one gather table per (batch, head)
    table = value.permute(0, 3, 1, 2, 4).reshape(n * m, h * w, d)
    out = torch.zeros(n * m, lq, d, dtype=value.dtype, device=value.device)
    for dy, dx in _CORNERS:
        xi, yi = x0i + dx, y0i + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wx = tx if dx else 1 - tx
        wy = ty if dy else 1 - ty
        wgt = (wx * wy * attn * valid).permute(0, 2, 1, 3).reshape(n * m, lq, p, 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).permute(0, 2, 1, 3).reshape(n * m, lq * p, 1)
        g = torch.gather(table, 1, idx.expand(-1, -1, d)).reshape(n * m, lq, p, d)
        out = out + (g * wgt).sum(dim=2)
    return out.reshape(n, m, lq, d).permute(0, 2, 1, 3)


def _corner_rows(h: int, w: int, loc: torch.Tensor, attn: torch.Tensor):
    """Flat HW index (clamped into the map) and combined bilinear × attention weight (zero
    for a corner outside the map) of each of the 4P corners of each query, corner
    k = 4·point + corner: two (N, M, Lq, 4P) tensors, ``rba_tpu``'s ``_corner_indices`` and
    ``_corner_weights``."""
    n, lq, m, p, _ = loc.shape
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    idxs, wgts = [], []
    for (dy, dx), wt in zip(_CORNERS, ((1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty)):
        yi, xi = y0i + dy, x0i + dx
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idxs.append(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        wgts.append(torch.where(valid, wt, 0.0) * attn)
    idx = torch.stack(idxs, -1).reshape(n, lq, m, 4 * p).permute(0, 2, 1, 3)
    wgt = torch.stack(wgts, -1).reshape(n, lq, m, 4 * p).permute(0, 2, 1, 3)
    return idx, wgt


def _build_rows(idx: torch.Tensor, wgt: torch.Tensor, hw: int) -> torch.Tensor:
    """The dense fp32 row matrix A (N, M, Lq, HW): each pixel sums its corners' weights in k order."""
    a = torch.zeros(*idx.shape[:3], hw, dtype=torch.float32, device=idx.device)
    for k in range(idx.shape[-1]):  # one index per row and k
        a.scatter_add_(-1, idx[..., k : k + 1], wgt[..., k : k + 1])
    return a


def _onehot_level(
    value: torch.Tensor,  # (N, H, W, M, D) fp32
    loc: torch.Tensor,  # (N, Lq, M, P, 2) fp32
    attn: torch.Tensor,  # (N, Lq, M, P) fp32
) -> torch.Tensor:  # (N, Lq, M, D) fp32
    """The bf16 one-hot form of ``rba_tpu/ops/deform_sampling.py`` (``_corner_indices``,
    ``_corner_weights``, ``_build_rows``, ``_onehot_apply``)."""
    n, h, w, m, d = value.shape
    idx, wgt = _corner_rows(h, w, loc, attn)
    a = _build_rows(idx, wgt, h * w)
    vh = value.reshape(n, h * w, m, d).permute(0, 2, 1, 3)  # (N, M, HW, D)
    # bf16 operands, fp32 products and sums: a bf16 matmul would round its output too
    out = torch.matmul(a.to(torch.bfloat16).float(), vh.to(torch.bfloat16).float())
    return out.permute(0, 2, 1, 3)


class OneHotLevel(torch.autograd.Function):
    """The bf16 one-hot level with ``rba_tpu``'s recompute-A backward
    (``_onehot_level_bwd``): only the inputs are saved, no (N, M, Lq, HW) row matrix;
    the backward rebuilds A in fp32 and runs at fp32 whatever the forward rounded.
    With S = g·Vᵀ: dV = Aᵀ·g, dwgt_k[q] = S[q, idx_k[q]] = ⟨g[q], V[idx_k[q]]⟩, and
    d(loc, attn) is the vector-Jacobian product of the corner weights."""

    @staticmethod
    def forward(ctx, value, loc, attn):
        ctx.save_for_backward(value, loc, attn)
        return _onehot_level(value, loc, attn)

    @staticmethod
    def backward(ctx, g):
        value, loc, attn = ctx.saved_tensors
        n, h, w, m, d = value.shape
        lq = loc.shape[1]
        gt = g.float().permute(0, 2, 1, 3)  # (N, M, Lq, D)
        with torch.enable_grad():
            loc_ = loc.detach().requires_grad_()
            attn_ = attn.detach().requires_grad_()
            idx, wgt = _corner_rows(h, w, loc_, attn_)
        a = _build_rows(idx, wgt.detach(), h * w)
        dvalue = torch.matmul(a.transpose(-1, -2), gt).permute(0, 2, 1, 3).reshape(n, h, w, m, d)
        vh = value.reshape(n, h * w, m, d).permute(0, 2, 1, 3)  # (N, M, HW, D)
        k = idx.shape[-1]
        corners = torch.gather(vh, 2, idx.reshape(n, m, lq * k, 1).expand(-1, -1, -1, d)).reshape(n, m, lq, k, d)
        dwgt = (gt[:, :, :, None, :] * corners).sum(-1)
        dloc, dattn = torch.autograd.grad(wgt, (loc_, attn_), dwgt)
        return dvalue, dloc, dattn


class _OpenBackwardSpan(torch.autograd.Function):
    """Identity on the sampling's output; its backward, the first of the sampling's
    backward, opens ``BACKWARD_SPAN`` and leaves the entered context in ``span`` (a
    no-op one when no profiler records), so the close exits what the open entered
    whether a profiler started or stopped in between."""

    @staticmethod
    def forward(ctx, span, out):
        ctx.span = span
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        opened = profiling.span(BACKWARD_SPAN)
        opened.__enter__()
        ctx.span.append(opened)
        return None, g


class _CloseBackwardSpan(torch.autograd.Function):
    """Identity on the sampling's inputs; its backward, which autograd runs once their
    three gradients are complete, closes the span that ``_OpenBackwardSpan`` opened."""

    @staticmethod
    def forward(ctx, span, *inputs):
        ctx.span = span
        return tuple(x.view_as(x) for x in inputs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.span:
            ctx.span.pop().__exit__(None, None, None)
        return (None, *grads)


def sampling_methods(
    n: int, m: int, lq: int, spatial_shapes: Sequence[Tuple[int, int]], method: str = "auto",
    onehot_cap: int = 192 * 1024 * 1024,
) -> Tuple[str, ...]:
    """The form of each level, ``"onehot"`` or ``"gather"``: ``"auto"`` takes the one-hot
    form where N·M·Lq·H·W <= ``onehot_cap`` (``rba_tpu``'s per-level dispatch)."""
    if method == "auto":
        return tuple("onehot" if n * m * lq * h * w <= onehot_cap else "gather" for h, w in spatial_shapes)
    if method == "gather_scatter":  # rba_tpu's plain-autodiff gather: the gather's function and gradient
        method = "gather"
    if method not in ("onehot", "gather"):
        raise ValueError(f"sampling method {method!r}")
    return (method,) * len(spatial_shapes)


def _aligned(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``x`` as fp32 and contiguous, copied where it does not start on ``nbytes`` (a view
    into the middle of a tensor may start anywhere)."""
    x = x.float().contiguous()
    return x if x.data_ptr() % nbytes == 0 else x.clone()


def ms_deform_attn_plain(
    value: torch.Tensor,  # (N, S, M, D) fp32
    spatial_shapes: Sequence[Tuple[int, int]],  # (H, W) per level
    sampling_locations: torch.Tensor,  # (N, Lq, M, L, P, 2) fp32
    attention_weights: torch.Tensor,  # (N, Lq, M, L, P) fp32
    onehot_levels: Collection[int] = (),
) -> torch.Tensor:  # (N, Lq, M·D) fp32
    """The plain version: each level sampled in plain PyTorch, the one-hot form for the
    levels in ``onehot_levels`` and the gather for the rest, summed over levels.  With no
    one-hot level it computes what Kernel F does."""
    n, _, m, d = value.shape
    lq = sampling_locations.shape[1]
    out = torch.zeros(n, lq, m, d, dtype=torch.float32, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        v = value[:, start : start + h * w].reshape(n, h, w, m, d)
        sample = OneHotLevel.apply if lid in onehot_levels else _sample_level
        out = out + sample(v, sampling_locations[:, :, :, lid], attention_weights[:, :, :, lid])
        start += h * w
    return out.reshape(n, lq, m * d)


def ms_deform_attn_core(
    value: torch.Tensor,  # (N, S, M, D) flattened multi-level values
    spatial_shapes: Sequence[Tuple[int, int]],  # (H, W) per level
    sampling_locations: torch.Tensor,  # (N, Lq, M, L, P, 2) in [0, 1]
    attention_weights: torch.Tensor,  # (N, Lq, M, L, P) softmaxed over L·P
    method: str = "auto",
    sampling_dtype: str = "float32",
    onehot_cap: int = 192 * 1024 * 1024,
) -> torch.Tensor:  # (N, Lq, M·D) fp32
    """The sampling of every level, summed: Kernel F where its ``takes`` says so, else the
    plain version (``ms_deform_attn_plain``)."""
    n, s, m, d = value.shape
    _, lq, _, nlevels, p, _ = sampling_locations.shape
    if nlevels != len(spatial_shapes):
        raise ValueError(f"{nlevels} levels of locations for {len(spatial_shapes)} shapes")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} do not sum to S = {s}")
    methods = sampling_methods(n, m, lq, spatial_shapes, method, onehot_cap)
    inputs = (value, sampling_locations, attention_weights)
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    if kernel.takes(value.device, needs_grad, methods, sampling_dtype, value.shape, sampling_locations.shape):
        with profiling.span(SPAN):
            return kernel.ms_deform_attn(_aligned(value, 16), spatial_shapes, _aligned(sampling_locations, 8),
                                  attention_weights.float().contiguous())
    span = [] if needs_grad else None
    if span is not None:
        value, sampling_locations, attention_weights = _CloseBackwardSpan.apply(span, *inputs)
    with profiling.span(SPAN):
        onehot = {lid for lid, form in enumerate(methods) if form == "onehot" and sampling_dtype == "bfloat16"}
        out = ms_deform_attn_plain(value.float(), spatial_shapes, sampling_locations.float(),
                                   attention_weights.float(), onehot)
    return out if span is None else _OpenBackwardSpan.apply(span, out)
