"""Tracing (counterpart of ``rba_tpu/utils/profiling.py``): the port's spans and a trace of them.

``span(name)`` is the port's one way to mark work for a profiler: a
``torch.profiler.record_function`` range while a profiler records, and otherwise one
shared no-op context, so a span costs a flag check when nothing records (entering
``record_function`` goes through the dispatcher even then).  A profile that records
the card (CUPTI) mirrors each span on the device, from the first to the last device
operation launched inside it.  The names of every span of the port are the constants
below; profiles are read by these names.  While a forward is captured as CUDA graphs
(``models/cuda_graphs.py`` ``spanwise``), ``span`` hands each span to the capture
(``splitting``), which gives its block a graph of its own and replays that graph inside
the span: the span then holds the same device operations as in the eager forward.

``device_trace`` records a ``torch.profiler`` trace of the host and, on the card, of its
kernels, and writes it to ``logdir`` as a Chrome/Perfetto trace, which TensorBoard's
profiler plugin also reads.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Callable, ContextManager, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

# one request of an entry (``maskformer_infer_rba``, or ``maskformer_infer`` called
# directly): the parent of every span below that the request opens
REQUEST = "request"
UPLOAD = "upload"  # the frames' copy to the model's device, before ``preprocess``
LAYERS = ("preprocess", "backbone", "pixel_decoder", "transformer_decoder", "rba_tail")  # a request's layers, in order
WINDOW_ATTENTION = "window_attention"  # each call of Kernel A's wrapper (``kernels/window_attention.py``)
DEFORM_SAMPLING = "deform_sampling"  # each call of ``ops/deform_sampling.py`` ``ms_deform_attn_core``
DEFORM_SAMPLING_BACKWARD = "deform_sampling_backward"  # and its backward, where autograd runs one
# the core of each MiT block's spatial-reduction attention (``models/mix_transformer.py``
# ``_attention``): q·kᵀ, the scale, the softmax with its casts, and the product with v
SR_ATTENTION = "sr_attention"
# the core of each ViTDet and MViT block's attention (``models/vit.py`` ``attention_core``):
# q·kᵀ, the relative-position tables' resampling and gathers, both position products, the
# casts, the softmax and the product with v
REL_POS_ATTENTION = "rel_pos_attention"
# the three pooling convs and LayerNorms of q, k and v in each MViT block
# (``models/mvit.py`` ``_ms_attention``)
QKV_POOL = "qkv_pool"
TRAIN_STEP = ("forward", "criterion", "backward", "optimizer")  # the parts of a train step
ALL_SPANS = (REQUEST, UPLOAD, *LAYERS, WINDOW_ATTENTION, DEFORM_SAMPLING, DEFORM_SAMPLING_BACKWARD, SR_ATTENTION,
             REL_POS_ATTENTION, QKV_POOL, *TRAIN_STEP)

_OFF = contextlib.nullcontext()
# set while a forward is captured as CUDA graphs split at its spans (``splitting``)
_SPLIT = contextvars.ContextVar("rba_tpu_torch.utils.profiling.split", default=None)


def span(name: str):
    """A context that marks its block as the span ``name`` for a profiler that records,
    and does nothing otherwise; inside ``splitting(split)``, ``split(name)``.  ``name`` is
    one of the constants of this module."""
    split = _SPLIT.get()
    if split is not None:
        return split(name)
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def splitting(split: Callable[[str], ContextManager]) -> Iterator[None]:
    """Inside the block, ``span(name)`` is ``split(name)``: how a CUDA-graph capture
    (``models/cuda_graphs.py`` ``spanwise``) puts each span's block in a graph of its own.
    It holds in the calling thread (and context) only."""
    token = _SPLIT.set(split)
    try:
        yield
    finally:
        _SPLIT.reset(token)


@contextlib.contextmanager
def device_trace(logdir: str = "rba_trace"):
    """Profile the block (CPU, and CUDA where a card is present); on exit write
    ``logdir/trace.json``.  Yields the profiler, whose ``key_averages()`` tables the
    recorded ops and kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
