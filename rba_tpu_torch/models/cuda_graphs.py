"""Piecewise CUDA-graph replay of a forward that keeps some calls eager.

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
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Dict, Generator, Hashable, Optional

import torch
from torch import nn

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


class _Pieces:
    """One forward captured at one input: its stretches' graphs, the eager calls between
    them with their output buffers, the static input and outputs."""

    def __init__(self, module: nn.Module, forward: Forward, x: torch.Tensor, call: Callable):
        self.weights = [*module.parameters(), *module.buffers()]
        self.ptrs = self._ptrs()
        self.x = x.clone()
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

    def _ptrs(self):
        return [t.data_ptr() for t in self.weights]

    def current(self) -> bool:
        """Whether every weight still lies where the graphs read it."""
        return self._ptrs() == self.ptrs

    def replay(self, x: torch.Tensor, call: Callable) -> None:
        self.x.copy_(x)
        graphs = iter(self.graphs)
        next(graphs).replay()
        for (args, out), graph in zip(self.calls, graphs):
            call(*args, out=out)
            graph.replay()
        piecewise.replays += len(self.graphs)

    def outputs(self) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.outs.items()}


def piecewise(module: nn.Module, forward: Forward, x: torch.Tensor, call: Callable,
              key: Optional[Hashable] = None) -> Dict[str, torch.Tensor]:
    """``forward(x)`` with its yielded calls made by ``call``: eagerly where ``key`` is
    None, else from CUDA graphs of ``module``'s forward at ``x``'s shape, dtype and
    device and ``key`` (what else tells the forward's captures apart), captured at the
    second such call.  ``call(*args)`` returns a new output, ``call(*args, out=buffer)``
    writes into ``buffer``."""
    if key is None:
        return _drive(forward(x), call)
    key = (tuple(x.shape), x.dtype, x.device, torch.is_inference_mode_enabled(), key)
    seen = _CACHE.setdefault(module, OrderedDict())
    if key not in seen:
        seen[key] = None
        while len(seen) > MAX_SHAPES:
            seen.popitem(last=False)
        return _drive(forward(x), call)
    seen.move_to_end(key)
    if seen[key] is not None and seen[key].current():
        seen[key].replay(x, call)
    else:
        seen[key] = None  # the old graphs go before the new capture takes its memory
        seen[key] = _Pieces(module, forward, x, call)
    return seen[key].outputs()


piecewise.captures = 0  # forwards captured since the last reset
piecewise.replays = 0  # graphs replayed since the last reset (a capture replays each of its own once)
