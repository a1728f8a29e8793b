"""Build the CUDA sources under ``rba_tpu_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``build/rba_tpu_torch/lib<name>.so`` at the root of
the checkout (listed in ``.gitignore``), on first use or when the source, or
any shared header ``csrc/*.cuh``, is newer than the library.  ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.  Nothing is
built at import time.

The build directory is the checkout's ``build/``: the port runs from a source
checkout or an editable install, not from a copy installed into site-packages.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rba_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of rba_tpu_torch need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any header in ``csrc``."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build_all(names: List[str] | None = None) -> Dict[str, float]:
    """Compile the named sources (default: every ``csrc/*.cu``) in parallel where stale.
    Returns the seconds each build took (0.0 when the library was current); the
    compiler's output, ptxas's register and shared-memory report included, goes to
    ``build/rba_tpu_torch/<name>.log``."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, _lib_path(name))
        else:
            failed.append(name)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if it is missing or stale."""
    if name not in _loaded:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.rba_error_string.argtypes = [ctypes.c_int]
        lib.rba_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need the gradient of a kernel that has none: grad mode on
    and an input that requires grad.  Training takes the plain-PyTorch branch instead."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no gradient: call it under torch.no_grad() or inference_mode, or train through the "
            "plain-PyTorch branch (attention=\"xla\")")


class Launcher:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, which takes the CUDA stream last
    and returns ``cudaGetLastError()``.  Its library is loaded, and built first where
    stale, at the first launch, never at import."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self._name, self._symbol, self._argtypes = name, symbol, [*argtypes, ctypes.c_void_p]
        self._lib = self._fn = None

    def __call__(self, wrapper: Callable, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream, raise if the launch returned a CUDA error,
        and count it in ``wrapper.launches``."""
        if self._fn is None:
            lib = load(self._name)
            fn = getattr(lib, self._symbol)
            fn.argtypes, fn.restype = self._argtypes, ctypes.c_int
            self._lib, self._fn = lib, fn
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{wrapper.__name__}: CUDA error {err}: {self._lib.rba_error_string(err).decode()}")
        wrapper.launches += 1
