"""Profiling helpers (counterpart of `deep_gcns_torch_tpu/utils/profiling.py`):

* `trace(log_dir)`: a `torch.profiler` trace of the enclosed block, written
  as a Chrome trace (`{log_dir}/trace.json`), the card's activity included
  when CUDA is available;
* `device_memory_stats(device)`: bytes in use and their peak from the CUDA
  caching allocator (`torch.cuda.memory_stats`), None on the CPU;
* `span(name)`: the port's own spans, one registry for the process, read
  by `summary()` and `records()`.

A span records only while a `torch.profiler` runs (torch's own flag,
`torch.autograd.profiler._is_profiler_enabled`) or inside `spans_on()`.
Otherwise it costs one flag check: no event, no allocation, no sync. Each
record holds its name, its parent (the innermost span open on the same
thread: the backward of a CUDA tensor runs on autograd's device thread),
its host interval on `time.time_ns()` (the clock of the profiler's
timestamps) and its device time: a CUDA event pair on the current stream
once CUDA is initialised, else the host interval. A span adds no profiler
event and no device work, so the profiler's device activity is the same
with spans as without.

A profiled stretch starts with an empty registry. A stretch ends where a
span, `summary()` or the outermost `spans_on()`'s exit finds the gate shut
(two profilers back to back with none of these between make one stretch);
its records stay in memory until the next stretch begins.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace(dir): step()` writes `{dir}/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """{"bytes_in_use", "peak_bytes_in_use"} of a CUDA device (default: the
    current one); None for both on the CPU or without a card."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return {"bytes_in_use": None, "peak_bytes_in_use": None}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak")}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class SpanRecord:
    """One span: ``start_ns``/``end_ns`` on `time.time_ns()` (``end_ns`` 0
    while open), ``thread`` the opener's `threading.get_ident()`, and
    ``device_ms`` once the span is closed and, on the card, read."""

    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns", "device_ms", "events")

    def __init__(self, name: str, parent: Optional["SpanRecord"], events):
        self.name, self.parent, self.events = name, parent, events
        self.thread = threading.get_ident()
        self.end_ns, self.device_ms = 0, None
        self.start_ns = time.time_ns()

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_records: List[SpanRecord] = []
_local = threading.local()
_forced = 0      # depth of open `spans_on()`
_live = False    # a stretch is recording into `_records`
_new_stretch = threading.Lock()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _records, _live
        if not _live:
            with _new_stretch:
                if not _live:
                    _records, _live = [], True
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        ev = None
        if torch.cuda.is_initialized():
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        rec = SpanRecord(self.name, stack[-1] if stack else None, ev)
        stack.append(rec)
        _records.append(rec)
        self.rec = rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if rec.events is None:
            rec.device_ms = rec.host_ms
        else:
            rec.events[1].record()
        _local.stack.pop()
        return False


def _gate() -> bool:
    return _autograd_profiler._is_profiler_enabled or _forced > 0


def span(name: str):
    """``with span("conv.attend"): ...``: a record while a profiler runs or
    inside `spans_on()`, else nothing."""
    global _live
    if not _gate():
        _live = False
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def spans_on():
    """Record spans without a profiler (operators and tests); the outermost
    `spans_on()` starts a new stretch and ends it."""
    global _forced, _live
    if not _gate():
        _live = False
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1
        if not _gate():
            _live = False


def records() -> List[SpanRecord]:
    """The current stretch's closed records, in the order they opened."""
    return [r for r in _records if r.end_ns]


def summary() -> Dict[str, Dict[str, float]]:
    """By span name: ``count``, the summed ``device_ms`` and ``host_ms``, and
    ``self_ms``, the device time less what the span's children cover. Syncs
    the device once where card records are still unread."""
    global _live
    if not _gate():
        _live = False
    recs = records()
    unread = [r for r in recs if r.events is not None]
    if unread:
        torch.cuda.synchronize()
        for r in unread:
            r.device_ms, r.events = r.events[0].elapsed_time(r.events[1]), None
    covered: Dict[int, float] = {}
    for r in recs:
        if r.parent is not None:
            covered[id(r.parent)] = covered.get(id(r.parent), 0.0) + r.device_ms
    out: Dict[str, Dict[str, float]] = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "device_ms": 0.0, "host_ms": 0.0,
                                    "self_ms": 0.0})
        s["count"] += 1
        s["device_ms"] += r.device_ms
        s["host_ms"] += r.host_ms
        s["self_ms"] += r.device_ms - covered.get(id(r), 0.0)
    return out
