"""Fixtures of the benchmark's CPU tests."""
import pytest

from .tiny import write_root


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path)
