"""The control of each cell comes out not correct.

On the card, at the cell's own size and limits (``perfbench.control``,
which the benchmark's runs never call). On the CPU, at tiny widths, the
control's machinery runs and reads worse than the program on the same
inputs."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from perfbench.control import readings

REPO = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS + ["toy-serve"])
def test_control_reads_worse_on_cpu(toy_root, workload):
    out = readings(toy_root, workload, 7, torch.device("cpu"))
    assert set(out["program"]) == set(out["control"]) == set(out["limits"])
    assert max(out["control"][k] - out["program"][k] for k in out["limits"]) > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(card, workload):
    out = readings(REPO, workload, 424242, card)
    assert out["control_fails"], out
