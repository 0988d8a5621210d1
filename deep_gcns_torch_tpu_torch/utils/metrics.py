"""Host-side metrics (counterpart of `deep_gcns_torch_tpu/utils/metrics.py:40-77`:
`accuracy` and `roc_auc`; the other metrics come with later slices)."""

from __future__ import annotations

import numpy as np


def accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    return float((np.asarray(pred) == np.asarray(labels)).mean())


def _binary_auc(score: np.ndarray, label: np.ndarray) -> float:
    """Mann-Whitney AUC with average ranks over ties; the JAX package's
    rank loop, vectorised over the runs of equal scores."""
    n = len(score)
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    starts = np.concatenate([[0], np.flatnonzero(s[1:] != s[:-1]) + 1])
    ends = np.concatenate([starts[1:], [n]])
    ranks = np.empty(n, float)
    ranks[order] = np.repeat(0.5 * (starts + ends - 1) + 1.0, ends - starts)
    pos = label > 0.5
    n_pos = int(pos.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Column-averaged ROC-AUC over the labeled (non-NaN) entries, skipping
    columns that lack either class (the OGB Evaluator's rule for
    ogbn-proteins)."""
    scores = np.asarray(scores, float)
    labels = np.asarray(labels, float)
    if scores.ndim == 1:
        scores, labels = scores[:, None], labels[:, None]
    aucs = []
    for c in range(scores.shape[1]):
        ok = ~np.isnan(labels[:, c])
        if ok.sum() == 0:
            continue
        a = _binary_auc(scores[ok, c], labels[ok, c])
        if not np.isnan(a):
            aucs.append(a)
    return float(np.mean(aucs)) if aucs else float("nan")
