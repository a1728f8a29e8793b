"""The kernel builder's staleness rule (``rba_tpu_torch/kernels/_build.py``): a
library is rebuilt when it is missing or older than its source or any shared
header in ``csrc``.  Runs on the CPU: no compiler is called."""
import os

import pytest

from rba_tpu_torch.kernels import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc with one source and one header and a build directory, both in tmp_path,
    and a helper that sets a file's mtime."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for path in (csrc / "k.cu", csrc / "mma.cuh", build / "libk.so"):
        path.write_text("")

    def at(path, mtime):
        os.utime(path, (mtime, mtime))

    return csrc, build, at


def test_library_newer_than_source_and_headers_is_current(tree):
    csrc, build, at = tree
    at(csrc / "k.cu", 100)
    at(csrc / "mma.cuh", 100)
    at(build / "libk.so", 200)
    assert not _build._stale("k")


@pytest.mark.parametrize("newer", ["k.cu", "mma.cuh"])
def test_newer_source_or_header_makes_the_library_stale(tree, newer):
    csrc, build, at = tree
    at(csrc / "k.cu", 100)
    at(csrc / "mma.cuh", 100)
    at(build / "libk.so", 200)
    at(csrc / newer, 300)
    assert _build._stale("k")


def test_missing_library_is_stale(tree):
    _, build, _ = tree
    (build / "libk.so").unlink()
    assert _build._stale("k")
