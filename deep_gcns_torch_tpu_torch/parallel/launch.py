"""Spawn D ranks of one program and collect their results.

    results = launch(fn, world, args, device="cpu", deadline=60.0)

Each rank is a process made with the ``spawn`` start method (never
``fork``: the caller may hold threads, such as JAX's, that a fork would
copy mid-flight). The child's entry point `_worker` lives here, so a child
imports torch and this package and nothing of its parent's modules but the
one that defines ``fn`` (which must be picklable: a module-level function).
Each rank joins the default process group through `comm.init_rank` (a
`FileStore` in a fresh temporary directory), runs ``fn(rank, world, *args)``
and sends back its return value.

Failure is never swallowed: the first rank that raises ends the launch with
its traceback in a `RankFailed`; a rank that dies without reporting ends it
with its exit code; and once ``deadline`` seconds have passed every rank
still running is killed and `TimeoutError` raised, so a collective that one
rank never joins fails a test in seconds. The process group's own timeout
is the deadline too, so a rank waiting on a collective raises by itself.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


class RankFailed(RuntimeError):
    """A rank raised or died; the message holds its rank and traceback."""


def _worker(rank: int, world: int, store_dir: str, device: str, threads: int,
            timeout_s: float, fn: Callable, args: Sequence, out) -> None:
    import torch

    from . import comm

    if threads:
        torch.set_num_threads(threads)
    try:
        comm.init_rank(rank, world, store_dir, device, timeout_s)
        # plain pickle bytes: a queue would hand tensors over as shared
        # memory, which dies with this process
        result = pickle.dumps(fn(rank, world, *args))
        out.put((rank, "ok", result))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)
    finally:
        comm.shutdown()


def _stop(procs):
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(5)


def launch(fn: Callable, world: int, args: Sequence = (), *, device: str = "cpu",
           deadline: float = 120.0, threads: int = 1) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks; returns the
    ranks' results in rank order. ``device`` "cpu" or "cuda" (rank r on
    ``cuda:(r % device_count)``, NCCL or gloo as `comm.pick_backend` says);
    ``threads`` sets each rank's `torch.set_num_threads` (0 leaves it)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="dgc_rdzv_")
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, store_dir, device, threads, deadline, fn,
                               tuple(args), out))
             for r in range(world)]
    t0 = time.monotonic()
    results: dict = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            left = deadline - (time.monotonic() - t0)
            if left <= 0:
                waiting = sorted(set(range(world)) - set(results))
                raise TimeoutError(f"launch: ranks {waiting} of {world} did not finish "
                                   f"within {deadline:.0f} s (killed)")
            try:
                rank, status, value = out.get(timeout=min(left, 0.25))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # a rank that raised has flushed its report before exiting
                    rank, status, value = out.get(timeout=2.0)
                except queue_mod.Empty:
                    raise RankFailed(f"rank {dead[0]} of {world} exited with code "
                                     f"{procs[dead[0]].exitcode} without a result") from None
            if status != "ok":
                raise RankFailed(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = pickle.loads(value)
        for p in procs:
            p.join(max(1.0, deadline - (time.monotonic() - t0)))
        for r, p in enumerate(procs):
            if p.exitcode not in (0, None):
                raise RankFailed(f"rank {r} of {world} exited with code {p.exitcode}")
        return [results[r] for r in range(world)]
    finally:
        _stop(procs)
        out.close()
        shutil.rmtree(store_dir, ignore_errors=True)

