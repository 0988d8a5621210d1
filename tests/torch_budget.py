"""One thread budget and one time limit for every port test.

Every ``tests/test_torch_*.py`` imports the autouse fixture::

    from torch_budget import budget  # noqa: F401

and the import is what turns it on for the file's tests.

Threads. Tier-1 runs six pytest workers on an eight-core host (``-n 6``).
torch's default intra-op pool takes every core in each of them, and its
small CPU ops then wait on each other far longer than they compute: beside a
busy run, a 4096 x 80 float32 ``index_add_`` took 326 ms with eight threads
and 0.3 ms with one. So each port test runs with `THREADS` torch threads,
and the count it found comes back afterwards. One beats two even for the
largest CPU test, ResGEN-28's reference: 1.4-4.4 s a case with one thread
beside a busy run, 5.2-8.5 s with two. Ranks spawned by `parallel.launch`
take their count from its ``threads`` argument, and a Python program that a
test runs takes `THREADS` through `child_env`'s ``OMP_NUM_THREADS``.

Time. The fixture arms `LIMIT_S` seconds of ``ITIMER_REAL`` around each test
(its later fixtures' set-up and teardown included), on the main thread
only: a test that hangs fails under its own name instead of cutting the whole
run. The limit is three times the costliest port test seen in a tier-1 run
(146 s: `test_torch_tensor_parallel.py`'s first test, which computes every
case), rounded up. The subprocess and spawn timeouts inside the tests stay at or
below `SUBPROCESS_S`, so that they fire first and report their own error.
"""

import contextlib
import os
import signal
import threading
import time

import pytest
import torch

THREADS = 1
LIMIT_S = 450.0
SUBPROCESS_S = 240.0


def child_env():
    """The environment of a Python program that a test runs: this one's, with
    `THREADS` torch threads (``OMP_NUM_THREADS``)."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS))


@contextlib.contextmanager
def limits(threads, seconds):
    """``threads`` torch threads and, on the main thread, an alarm that fails
    the test after ``seconds``; on exit the thread count and any alarm that
    was armed before (less the time spent here) come back."""
    old_threads = torch.get_num_threads()
    torch.set_num_threads(threads)
    armed = threading.current_thread() is threading.main_thread()
    if armed:
        def expired(signum, frame):
            pytest.fail(f"test ran past its time limit of {seconds:g} s "
                        f"(tests/torch_budget.py)")

        t0 = time.monotonic()
        handler = signal.signal(signal.SIGALRM, expired)
        outer, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        if armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, handler)
            if outer:
                signal.setitimer(signal.ITIMER_REAL,
                                 max(outer - (time.monotonic() - t0), 1e-3))
        torch.set_num_threads(old_threads)


@pytest.fixture(autouse=True)
def budget():
    """`THREADS` torch threads and a `LIMIT_S` alarm for one test."""
    with limits(THREADS, LIMIT_S):
        yield
