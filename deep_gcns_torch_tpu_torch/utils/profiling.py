"""Profiling helpers (counterpart of `deep_gcns_torch_tpu/utils/profiling.py`):

* `trace(log_dir)`: a `torch.profiler` trace of the enclosed block, written
  as a Chrome trace (`{log_dir}/trace.json`), the card's activity included
  when CUDA is available;
* `device_memory_stats(device)`: bytes in use and their peak from the CUDA
  caching allocator (`torch.cuda.memory_stats`), None on the CPU;
* `EdgeRateMeter`: edge-messages per second across steps.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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


class EdgeRateMeter:
    """Edge-messages per second across steps: `start()`, then
    `update(edges)` after each step."""

    def __init__(self):
        self.edges = 0
        self.t0: Optional[float] = None
        self.elapsed = 0.0

    def start(self):
        self.t0 = time.time()

    def update(self, edges: int):
        if self.t0 is None:
            raise RuntimeError("call start() first")
        self.elapsed += time.time() - self.t0
        self.edges += int(edges)
        self.t0 = time.time()

    def rate(self) -> float:
        return self.edges / self.elapsed if self.elapsed > 0 else 0.0
