"""The port's hand-written CUDA kernels, and the one switch that sets them aside.

Every kernel has a plain PyTorch version.  Whether a call runs the kernel or its plain
version is decided in the kernel's own module, by its ``takes(...)`` rule, from what the
call can observe: the device, the dtype, the shapes and whether autograd needs a
gradient.  Under ``plain_versions()`` every rule answers no, so everything that runs
inside it, from any entry down to the kernels, takes the plain versions; that is how
the card's tests hold each path against them.  Nothing between an entry and a kernel
knows of the choice.

This package imports nothing from ``ops``, ``models`` or ``train``: they import it.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

# read by the ``takes`` rules alone
_PLAIN = contextvars.ContextVar("rba_tpu_torch.kernels.plain_versions", default=False)


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run every kernel's plain version inside the block, on every device.  It nests, and
    restores the outer setting on exit, an exception's included.  It holds in the calling
    thread (and context) only: the port runs its model there."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)
