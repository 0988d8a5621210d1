"""Shared fixtures of the benchmark's tests: each cell cut to a tiny size
(the CPU runs the port's plain kernel versions), and the card for the tests
marked ``cuda``, decided inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)



def cells():
    """The workloads of `BENCHMARK.json`, by name."""
    from h100bench import harness

    return [w["name"] for w in harness.benchmark()["workloads"]]


def tiny_cell(name: str, n: int = 600):
    """The cell with its graph cut for a CPU test (600 nodes of degree 4 in 8
    communities); the configuration keeps its widths and depth."""
    from h100bench import harness

    c = harness.resolve_cell(name)
    tr = c.traffic
    c.traffic = dict(tr, params=dict(tr["params"], n=n, avg_degree=4, n_comm=8),
                     splits={"train": n // 2, "valid": n // 4, "test": n - n // 2 - n // 4})
    return c


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
