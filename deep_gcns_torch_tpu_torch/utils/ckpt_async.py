"""Asynchronous rolling checkpoints (counterpart of
`deep_gcns_torch_tpu/utils/ckpt_async.py`, which rides orbax).

`save` copies the model's and the optimizer's state dicts to the CPU on the
caller's thread (after that the caller may update the parameters) and writes
them with `torch.save` on one worker thread, so the write overlaps the next
training steps. Each step is a directory `{directory}/{step}/` holding the
reference-format `ckpt.pth` and `ckpt.json` of `utils/ckpt.py`; its
`ckpt.json` is written last, so a step without it is incomplete and ignored.

Retention follows the JAX module's two conventions: the latest
``max_to_keep`` steps are kept, and with ``keep_best`` the step with the best
metric (`metrics["best"]`, else `metrics["valid"]`; the larger with
``best_mode`` "max", the smaller with "min") is kept as well. A save without
metrics ranks below every save with one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from .ckpt import checkpoint_payload, load_ckpt, write_payload


class AsyncCheckpointer:
    """Rolling asynchronous checkpoints of a model and its optimizer.

    Usage::

        ckpt = AsyncCheckpointer(dir, max_to_keep=3)
        for epoch in ...:
            ...train...
            ckpt.save(epoch, model=model, optimizer=opt, metrics={"valid": v},
                      meta={"lr": lr})
        ckpt.wait()

        # resume
        meta = ckpt.restore(model=model, optimizer=opt)
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3, keep_best: bool = True,
                 best_mode: str = "max"):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep, self._keep_best, self._best_mode = max_to_keep, keep_best, best_mode
        self._lock = threading.Lock()
        self._metric: Dict[int, Optional[float]] = {}  # every step saved or enqueued
        for name in os.listdir(self._dir):
            meta = os.path.join(self._dir, name, "ckpt.json")
            if name.isdigit() and os.path.exists(meta):
                with open(meta) as f:
                    self._metric[int(name)] = self._rank_value(json.load(f).get("metrics"))
        self._written = set(self._metric)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending: List[Future] = []

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(step), "ckpt")

    @staticmethod
    def _rank_value(metrics: Optional[dict]) -> Optional[float]:
        if not metrics:
            return None
        return float(metrics.get("best", metrics.get("valid", 0.0)))

    def save(self, step: int, *, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             metrics: Optional[Dict[str, float]] = None,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot the state dicts to the CPU now; write them on the worker."""
        extra = dict(meta or {})
        extra["step"] = int(step)
        extra["metrics"] = {k: float(v) for k, v in (metrics or {}).items()}
        payload = checkpoint_payload(model, optimizer, extra.get("epoch", step),
                                     extra.get("best_value", -float("inf")), extra)
        with self._lock:
            self._metric[int(step)] = self._rank_value(metrics)
        self._pending.append(self._pool.submit(self._write, int(step), payload))

    def _write(self, step: int, payload: dict):
        os.makedirs(os.path.dirname(self._path(step)), exist_ok=True)
        write_payload(self._path(step), payload)
        with self._lock:
            self._written.add(step)
            # only written steps go: an enqueued one is pruned after its write
            for old in sorted(self._written - self._keep()):
                shutil.rmtree(os.path.dirname(self._path(old)), ignore_errors=True)
                del self._metric[old]
                self._written.discard(old)

    def _keep(self) -> set:
        keep = set(sorted(self._metric)[-self._max_to_keep:]) if self._max_to_keep else set()
        best = self._best_locked()
        if self._keep_best and best is not None:
            keep.add(best)
        return keep

    def _best_locked(self) -> Optional[int]:
        ranked = [(v, s) for s, v in self._metric.items() if v is not None]
        if not ranked:
            return None
        sign = 1.0 if self._best_mode == "max" else -1.0
        # ties go to the later step
        return max(ranked, key=lambda vs: (sign * vs[0], vs[1]))[1]

    def restore(self, step: Optional[int] = None, *, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                map_location=None) -> Dict[str, Any]:
        """Load ``step`` (default: the latest) into ``model`` and
        ``optimizer`` in place, after the pending writes; returns its
        metadata (with "step")."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return load_ckpt(self._path(step), model=model, optimizer=optimizer,
                         map_location=map_location)

    def latest_step(self) -> Optional[int]:
        with self._lock:
            return max(self._metric) if self._metric else None

    def best_step(self) -> Optional[int]:
        with self._lock:
            return self._best_locked()

    def wait(self) -> None:
        """Block until every enqueued save is on disk; re-raises a failed
        write."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
