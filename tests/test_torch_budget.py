"""The shared budget of the port's tests (`tests/torch_budget.py`): the
thread count inside a test, the time limit and its message, what comes back
afterwards, and that every port test file takes the budget."""

import glob
import os
import re
import signal
import time

import pytest
import torch

import torch_budget
from torch_budget import budget  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))


def test_a_test_runs_at_the_budget_under_the_limit():
    assert torch.get_num_threads() == torch_budget.THREADS
    left, interval = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= torch_budget.LIMIT_S and interval == 0
    assert torch_budget.SUBPROCESS_S < torch_budget.LIMIT_S


def test_a_body_past_the_limit_fails_with_its_message():
    with pytest.raises(pytest.fail.Exception, match="past its time limit of 0.2 s"):
        with torch_budget.limits(torch_budget.THREADS, 0.2):
            time.sleep(5)


def test_the_count_and_the_outer_limit_come_back():
    threads = torch.get_num_threads()
    handler = signal.getsignal(signal.SIGALRM)
    outer = signal.getitimer(signal.ITIMER_REAL)[0]
    with torch_budget.limits(threads + 2, 30):
        assert torch.get_num_threads() == threads + 2
        assert 29 < signal.getitimer(signal.ITIMER_REAL)[0] <= 30
    assert torch.get_num_threads() == threads
    assert signal.getsignal(signal.SIGALRM) is handler
    assert 0 < outer - 5 < signal.getitimer(signal.ITIMER_REAL)[0] <= outer


def test_every_port_test_file_takes_the_budget():
    """Each `test_torch_*.py` imports the helper's fixture and pins no
    threads of its own."""
    files = sorted(glob.glob(os.path.join(HERE, "test_torch_*.py")))
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            src = f.read()
        assert "from torch_budget import budget  # noqa: F401\n" in src, path
        assert not re.search(r"torch\.set_num_threads\(", src), path
