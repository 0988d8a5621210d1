"""The loop's control flow at a tiny size on the CPU, and the command's
refusal to run without a card."""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from conftest import ROOT, tiny_cell
from h100bench import harness


class FakeJob:
    def __init__(self):
        self.calls = []

    def host(self, epoch):
        self.calls.append(("host", epoch))
        return epoch

    def train(self, a):
        self.calls.append(("train", a))
        return torch.tensor(float(a))

    def predict(self):
        self.calls.append(("predict",))
        return torch.zeros(3, dtype=torch.long)

    def accuracies(self, pred):
        return {}


def test_run_epochs_runs_whole_periods_and_evaluates_every_fifth():
    job = FakeJob()
    stops = []

    def done(epoch):
        stops.append(epoch)
        return epoch >= 15
    res = harness.run_epochs(job, 5, done, 5, harness.Spans())
    assert res["epochs"] == 10 and res["losses"] == [5.0, 10.0] and res["nonfinite"] == 0
    assert stops == [10, 15]
    assert [c for c in job.calls if c[0] == "train"] == [("train", e) for e in range(5, 15)]
    assert sum(c[0] == "predict" for c in job.calls) == 2


def test_drive_on_the_cpu_counts_whole_periods():
    import run  # noqa: F401  (h100bench/run.py, on the path below)

    cell = tiny_cell("revgat5-arxiv-csc")
    out = run.drive(cell, 2 ** 31 + 11, 0.2, False, torch.device("cpu"), 0.0)
    assert out["attempted"] >= 5 and out["attempted"] % 5 == 0
    assert set(out["metrics"]) == {"epoch_ms", "setup_s"}  # no device peak on the CPU
    assert out["correct"] is True and list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"


def test_the_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, os.path.join(ROOT, "h100bench", "run.py"), "--workload",
                        "revgat5-arxiv-csc", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr
