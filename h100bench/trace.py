"""Reduction of one `torch.profiler` window (device activity only, so that
tracing leaves the host's pace alone): the union of the device's activity
(busy seconds), the window's length, device time by operation and by kernel,
and the idle gaps labelled by the benchmark's host span that was running
when the device waited.

The host spans are wall-clock intervals (``time.time_ns``), the clock of
the profiler's timestamps. The window runs from the first span's start to
the last span's or device event's end. Device activity is every event off
the CPU with a duration (kernels, copies, sets)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    # the first device event's start after the first host span's (a clock check)
    first_device_s: Optional[float] = None

    def kernel(self, token: str) -> Tuple[float, int]:
        """(seconds, calls) of the port's kernels (``dgc::`` names) whose
        name holds ``token``."""
        s = c = 0
        for name, (sec, count) in self.by_name.items():
            if "dgc::" in name and token in name:
                s, c = s + sec, c + count
        return s, c

    def breakdown(self) -> Dict[str, List]:
        """The device operations that took most time, and the idle time
        summed by the host span the device waited in (seconds)."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        idle: Dict[str, float] = {}
        for name, sec in self.gaps:
            idle[name] = idle.get(name, 0.0) + sec
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])]
                [:TOP]}


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label(spans: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost (latest started) span that holds time ``t``."""
    best, start = "none", -1
    for a, b, name in spans:
        if a <= t <= b and a > start:
            best, start = name, a
    return best


def summarize(events, spans: List[Tuple[int, int, str]]) -> TraceSummary:
    """``events``: the profiler's kineto events (``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``); ``spans``: the
    host spans (start ns, end ns, name)."""
    from torch.autograd import DeviceType

    dev = []
    by_name: Dict[str, List[float]] = {}
    for e in events:
        name, dur = e.name(), e.duration_ns()
        if e.device_type() == DeviceType.CPU or dur <= 0:
            continue
        a = e.start_ns()
        dev.append((a, a + dur))
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += dur / 1e9
        acc[1] += 1
    if not spans:
        return TraceSummary(window_s=0.0, busy_s=0.0)
    lo = min(a for a, _, _ in spans)
    hi = max([b for _, b, _ in spans] + [b for _, b in dev])
    merged = _merge([(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi])
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], lo
    for a, b in merged + [(hi, hi)]:
        if a > prev:
            gaps.append((_label(spans, (a + prev) // 2), (a - prev) / 1e9))
        prev = max(prev, b)
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                        by_name={k: (v[0], int(v[1])) for k, v in by_name.items()}, gaps=gaps,
                        first_device_s=((min(a for a, _ in dev) - lo) / 1e9) if dev else None)
