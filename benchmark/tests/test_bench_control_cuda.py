"""On the card, at each cell's own size: the control (the reference at the precision below
the configuration's, in the program's place) is not correct, and the program is."""
from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import run

from .tiny import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(workload: str, control: int) -> dict:
    cell = run.load_cell(workload)
    args = run.parse_args(["--workload", workload, "--seed", "424242", "--seconds", "1", "--control", str(control)])
    return run.run_cell(cell, args, t0=time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    res = _run(workload, control=1)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(card, workload):
    res = _run(workload, control=0)
    assert res["correct"], res["checks"]
