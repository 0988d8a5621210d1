"""A run with the timed path broken underneath comes out not correct, for
each fault a training cell can have (the state left unchanged, half of the
batch left out of the mean, an answer altered where it is produced), and so
does the control, the configuration computed in bfloat16. The harness's look
for a card is skipped: `run.drive` on the CPU at a tiny size, held to each
cell's own limits. The test marked ``cuda`` does the same on the card at the
cells' full widths and depth on a smaller graph, for the cells of
`BENCHMARK.json`."""

import functools
import os
import sys

import pytest
import torch

from conftest import ROOT, cells, tiny_cell
from h100bench import faults, harness

sys.path.insert(0, os.path.join(ROOT, "h100bench"))
import run  # noqa: E402


def _drive(cell, device, mode, monkeypatch, seed=7):
    if mode == "control":
        cell.config = faults.control_config(cell.config)
    elif mode != "program":
        monkeypatch.setattr(harness, "setup_job", functools.partial(harness.setup_job,
                                                                    fault=faults.get(mode)))
    return run.drive(cell, seed, 0.0, False, device, 0.0)


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("mode", ["program", "frozen", "half", "answer", "control"])
def test_faults_come_out_not_correct(name, mode, monkeypatch):
    out = _drive(tiny_cell(name), torch.device("cpu"), mode, monkeypatch)
    assert out["correct"] is (mode == "program"), out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("mode", ["program", "half", "answer", "control"])
def test_faults_on_the_card(name, mode, monkeypatch, cuda_device):
    cell = harness.resolve_cell(name)
    n = 20_000
    cell.traffic = dict(cell.traffic, params=dict(cell.traffic["params"], n=n),
                        splits={"train": n // 2, "valid": n // 4, "test": n - n // 2 - n // 4})
    out = _drive(cell, cuda_device, mode, monkeypatch)
    assert out["correct"] is (mode == "program"), out["checks"]
