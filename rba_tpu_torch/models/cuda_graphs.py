"""CUDA-graph replay of a forward: piecewise, around calls kept eager, or split at its spans.

A forward is written once, as a generator: it yields the arguments of each call that
must stay eager (a hand kernel inside its profiler span, which a graph would swallow)
and is sent back that call's output; its return value, a dict of tensors, is the
forward's.  ``piecewise`` drives it.  Without a key it makes each call as it comes: the
eager forward.  With a key (the caller's rule allows graphs), the first call of an
input's shape runs eagerly as well, the warm-up that loads cuBLAS's, cuDNN's and the
kernels' libraries; the second captures each stretch between two eager calls into its
own ``torch.cuda.CUDAGraph``, all in one memory pool, replaying each as soon as it is
captured so that the call computes its result; every later call copies its input into
the static one and replays the stretches in turn, with the eager calls between them
writing into the buffers that the next stretch reads (``call(*args, out=buffer)``).

The graphs read the module's weights where they lay at capture: a copy into them
(``load_state_dict``) shows at the next replay, and a weight moved to other memory
(``.to``, ``.data =``) is seen and the forward captured anew.  The outputs are copied
out of the pool, so a caller never holds a tensor that the next replay overwrites.
Each module keeps the captures of at most ``MAX_SHAPES`` keys.

``spanwise`` replays a forward with no eager call, a plain function, as CUDA graphs split
at its spans (``utils/profiling.py`` ``span``): each span's block is captured as a graph
of its own and replayed inside its span, so a profile reads the same device operations
in each span as in the eager forward; each stretch between two spans is a graph too.  It
warms up, captures and keeps its captures as ``piecewise`` does.
"""
from __future__ import annotations

import contextlib
import warnings
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Generator, Hashable, List, Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import span, splitting

# inputs (shape, dtype, device, key) kept per module, the least recently used dropped first:
# TTA's six scales fit, so a frame's variants replay what the frame before captured
MAX_SHAPES = 8

Forward = Callable[[torch.Tensor], Generator[tuple, torch.Tensor, Dict[str, torch.Tensor]]]

# module -> OrderedDict of input key -> None (seen once, eagerly) or its _Pieces
_CACHE: "weakref.WeakKeyDictionary[nn.Module, OrderedDict]" = weakref.WeakKeyDictionary()


def _drive(gen, call: Callable) -> Dict[str, torch.Tensor]:
    """Run the generator to its end, making each call it yields."""
    sent = None
    while True:
        try:
            args = gen.send(sent)
        except StopIteration as stop:
            return stop.value
        sent = call(*args)


class _Captured:
    """A forward captured at one input: the weights it read and where they lay, its
    static input ``x`` and its outputs ``outs`` in the graphs' pool."""

    def __init__(self, module: nn.Module, x: torch.Tensor):
        self.weights = [*module.parameters(), *module.buffers()]
        self.ptrs = self._ptrs()
        self.x = x.clone()

    def _ptrs(self):
        return [t.data_ptr() for t in self.weights]

    def current(self) -> bool:
        """Whether every weight still lies where the graphs read it."""
        return self._ptrs() == self.ptrs

    def outputs(self) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.outs.items()}


class _Pieces(_Captured):
    """One forward captured at one input: its stretches' graphs, the eager calls between
    them with their output buffers, the static input and outputs."""

    def __init__(self, module: nn.Module, forward: Forward, x: torch.Tensor, call: Callable):
        super().__init__(module, x)
        self.graphs, self.calls = [], []
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(x.device)
        gen, sent, args = forward(self.x), None, ()
        while args is not None:
            graph = torch.cuda.CUDAGraph()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    args = gen.send(sent)
                except StopIteration as stop:
                    args, self.outs = None, stop.value
                finally:
                    graph.capture_end()
            torch.cuda.current_stream().wait_stream(stream)
            graph.replay()
            self.graphs.append(graph)
            if args is not None:
                sent = call(*args)
                self.calls.append((args, sent))
        piecewise.captures += 1
        piecewise.replays += len(self.graphs)

    def replay(self, x: torch.Tensor, call: Callable) -> None:
        self.x.copy_(x)
        graphs = iter(self.graphs)
        next(graphs).replay()
        for (args, out), graph in zip(self.calls, graphs):
            call(*args, out=out)
            graph.replay()
        piecewise.replays += len(self.graphs)


class _Spans(_Captured):
    """One forward captured at one input as graphs split at its spans: (the span's name,
    or None for a stretch between spans, its graph) in order, the static input and
    outputs."""

    def __init__(self, module: nn.Module, forward: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                 x: torch.Tensor):
        super().__init__(module, x)
        self.graphs: List[Tuple[Optional[str], torch.cuda.CUDAGraph]] = []
        self._pool, self._inside = torch.cuda.graph_pool_handle(), False
        stream = torch.cuda.Stream(x.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._begin(None)
            try:
                with splitting(self._split):
                    self.outs = forward(self.x)
            finally:
                self._end()
        torch.cuda.current_stream().wait_stream(stream)
        self.replay(x, None)
        spanwise.captures += 1

    def _begin(self, name: Optional[str]) -> None:
        self.graphs.append((name, torch.cuda.CUDAGraph()))
        self.graphs[-1][1].capture_begin(pool=self._pool)

    def _end(self) -> None:
        with warnings.catch_warnings():
            # a stretch between two spans may launch nothing (a view of the span's output
            # passed to the next span): its graph is empty and its replay does nothing
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            self.graphs[-1][1].capture_end()

    @contextlib.contextmanager
    def _split(self, name: str):
        """The span ``name``'s block, captured as a graph of its own."""
        if self._inside:
            raise RuntimeError(f"span {name!r} opens inside another span: a capture splits at one level only")
        self._end()
        self._begin(name)
        self._inside = True
        try:
            yield
        finally:
            self._inside = False
            self._end()
            self._begin(None)

    def replay(self, x: torch.Tensor, call: Optional[Callable] = None) -> None:
        """``call`` is piecewise's, and None here: the forward makes no eager call."""
        self.x.copy_(x)
        for name, graph in self.graphs:
            if name is None:
                graph.replay()
            else:
                with span(name):
                    graph.replay()
        spanwise.replays += len(self.graphs)


def _graphed(module: nn.Module, x: torch.Tensor, key: Hashable, eager: Callable, capture: Callable,
             call: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """The cache of both helpers: ``eager(x)`` at a key's first call, ``capture(x)`` at
    its second (and where a weight has moved), a replay of that capture after."""
    key = (tuple(x.shape), x.dtype, x.device, torch.is_inference_mode_enabled(), key)
    seen = _CACHE.setdefault(module, OrderedDict())
    if key not in seen:
        seen[key] = None
        while len(seen) > MAX_SHAPES:
            seen.popitem(last=False)
        return eager(x)
    seen.move_to_end(key)
    if seen[key] is not None and seen[key].current():
        seen[key].replay(x, call)
    else:
        seen[key] = None  # the old graphs go before the new capture takes its memory
        seen[key] = capture(x)
    return seen[key].outputs()


def piecewise(module: nn.Module, forward: Forward, x: torch.Tensor, call: Callable,
              key: Optional[Hashable] = None) -> Dict[str, torch.Tensor]:
    """``forward(x)`` with its yielded calls made by ``call``: eagerly where ``key`` is
    None, else from CUDA graphs of ``module``'s forward at ``x``'s shape, dtype and
    device and ``key`` (what else tells the forward's captures apart), captured at the
    second such call.  ``call(*args)`` returns a new output, ``call(*args, out=buffer)``
    writes into ``buffer``."""
    if key is None:
        return _drive(forward(x), call)
    return _graphed(module, x, key, lambda x: _drive(forward(x), call), lambda x: _Pieces(module, forward, x, call),
                    call)


def spanwise(module: nn.Module, forward: Callable[[torch.Tensor], Dict[str, torch.Tensor]], x: torch.Tensor,
             key: Optional[Hashable] = None) -> Dict[str, torch.Tensor]:
    """``forward(x)``: eagerly where ``key`` is None, else from CUDA graphs of
    ``module``'s forward at ``x``'s shape, dtype and device and ``key``, captured at the
    second such call, one graph per span and per stretch between spans, each span's
    replayed inside the span.  Spans inside the forward do not nest."""
    if key is None:
        return forward(x)
    return _graphed(module, x, key, forward, lambda x: _Spans(module, forward, x))


piecewise.captures = 0  # forwards captured since the last reset
piecewise.replays = 0  # graphs replayed since the last reset (a capture replays each of its own once)
spanwise.captures = 0  # as piecewise's, for spanwise
spanwise.replays = 0
