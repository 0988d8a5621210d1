"""Host-side metrics (counterpart of `deep_gcns_torch_tpu/utils/metrics.py`;
the other metrics come with later slices)."""

from __future__ import annotations

import numpy as np


def accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    return float((np.asarray(pred) == np.asarray(labels)).mean())
