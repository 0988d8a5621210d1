"""Faults planted under the timed path, to show that ``correct`` catches them
(the tests) and to read where they land (`calibrate.py`). Each takes the
job after its weights are drawn and breaks it in place.

* ``frozen``: the optimizer step returns the state unchanged;
* ``half``: the loss is the mean over half of the supervised rows;
* ``answer``: the evaluation's answer is altered on one node in a hundred;
* ``control``: not a fault of the job but the configuration computed in
  the next precision below its own (bfloat16 for float32, the app's
  ``--compute_dtype``), `calibrate.py`'s control."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def _halve(mask: torch.Tensor) -> torch.Tensor:
    idx = mask.nonzero()[:, 0]
    out = torch.zeros_like(mask)
    out[idx[: idx.numel() // 2]] = True
    return out


def frozen(job):
    job.opt.step = lambda *a, **k: None


def half(job):
    if hasattr(job, "train_mask"):
        job.train_mask = _halve(job.train_mask)
        return
    host = job.host

    def halved(epoch):
        *rest, sup = host(epoch)
        return (*rest, _halve(sup))
    job.host = halved


def answer(job):
    predict = job.predict

    def altered():
        pred = predict().clone()
        k = int(job.data.labels.max()) + 1
        pred[::100] = (pred[::100] + 1) % k
        return pred
    job.predict = altered


FAULTS: Dict[str, Callable] = {"frozen": frozen, "half": half, "answer": answer}


def control_config(cfg: Dict) -> Dict:
    """The configuration in the next precision below its own."""
    if cfg.get("compute_dtype", "float32") != "float32":
        raise ValueError("the control is defined for float32 configurations")
    return dict(cfg, compute_dtype="bfloat16")


def get(mode: str) -> Optional[Callable]:
    return FAULTS.get(mode)
