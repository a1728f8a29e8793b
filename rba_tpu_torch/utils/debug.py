"""Numerical debugging helpers (counterpart of ``rba_tpu/utils/debug.py``).

``print_stats`` and ``assert_finite`` are the reference's helpers.  ``checked(fn)`` is
the counterpart of ``rba_tpu``'s ``checkify`` wrapper with ``float_checks``: every
operation that ``fn`` runs is checked as it runs (a ``TorchDispatchMode`` sees each
op's outputs, intermediates included), and the first that produces a NaN, or an Inf
from a division, raises ``FloatingPointError`` naming the op and the line of the
caller's code that ran it.
"""
from __future__ import annotations

import functools
import os
import traceback
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def print_stats(x: torch.Tensor, name: str = "tensor") -> None:
    """(min, max, mean, std) of ``x``, as the reference's print_stats helpers print them
    (the population std, as ``jnp.std``)."""
    x32 = x.detach().float()
    print(f"{name}: (Min, Max, Mean, STD) {x32.min().item()} {x32.max().item()} {x32.mean().item()} "
          f"{x32.std(correction=0).item()}")


def assert_finite(x: torch.Tensor, name: str = "tensor") -> None:
    if not bool(torch.isfinite(x.detach().float()).all()):
        raise FloatingPointError(f"{name} has NaN/Inf")


_POLES = {  # ops whose finite inputs reach Inf at a pole (checkify's div_checks and log(0))
    "div", "div_", "reciprocal", "reciprocal_", "rsqrt", "rsqrt_", "true_divide", "log", "log_"}
_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


def _caller() -> str:
    """file:line of the innermost frame outside torch and this module."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if not path.startswith((_TORCH, _HERE)):
            return f"{frame.filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


class _FloatChecks(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        name = func.overloadpacket.__name__
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or not t.is_floating_point() or t.device.type == "meta":
                continue
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by aten.{name} (op {self.ops} of the call) at {_caller()}")
            if name in _POLES and bool(torch.isinf(t).any()):
                finite_in = all(bool(torch.isfinite(a).all()) for a in tree_flatten(args)[0]
                                if isinstance(a, torch.Tensor) and a.is_floating_point())
                if finite_in:
                    raise FloatingPointError(f"Inf produced by aten.{name} (op {self.ops} of the call) at "
                                             f"{_caller()}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` that raises ``FloatingPointError`` at the first NaN (or Inf from a division
    of finite numbers) that any of its operations produces, instead of letting it
    propagate.  Each op's outputs are read back to be checked, so it runs slower."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapper
