"""Host-side metrics (counterpart of `deep_gcns_torch_tpu/utils/metrics.py`),
pure numpy:

* roc_auc: rank-based (Mann-Whitney), column-averaged over labeled entries,
  the OGB Evaluator's rule for ogbn-proteins and ogbg-molhiv;
* average_precision: column-averaged AP (ogbg-molpcba);
* accuracy (ogbn-arxiv, products, ppa), balanced_accuracy (ModelNet40's
  mean per-class recall), micro_f1 (PPI);
* IoUAccumulator (S3DIS mIoU), part_seg_miou (PartNet), hits_at_k
  (ogbl-collab); AverageMeter (reference `utils/metrics.py:8-24`).
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Running average (reference `utils/metrics.py:8-24`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


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


def _columns(scores, labels):
    scores = np.asarray(scores, float)
    labels = np.asarray(labels, float)
    if scores.ndim == 1:
        scores, labels = scores[:, None], labels[:, None]
    return scores, labels


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Column-averaged ROC-AUC over the labeled (non-NaN) entries, skipping
    columns that lack either class."""
    scores, labels = _columns(scores, labels)
    aucs = []
    for c in range(scores.shape[1]):
        ok = ~np.isnan(labels[:, c])
        if ok.sum() == 0:
            continue
        a = _binary_auc(scores[ok, c], labels[ok, c])
        if not np.isnan(a):
            aucs.append(a)
    return float(np.mean(aucs)) if aucs else float("nan")


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """Column-averaged AP over the labeled entries, skipping columns that
    lack either class."""
    scores, labels = _columns(scores, labels)
    aps = []
    for c in range(scores.shape[1]):
        ok = ~np.isnan(labels[:, c])
        y, s = labels[ok, c], scores[ok, c]
        if ok.sum() == 0 or y.sum() == 0 or y.sum() == len(y):
            continue
        y = y[np.argsort(-s, kind="mergesort")]
        precision = np.cumsum(y) / np.arange(1, len(y) + 1)
        aps.append(float((precision * y).sum() / y.sum()))
    return float(np.mean(aps)) if aps else float("nan")


def balanced_accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    """Mean per-class recall."""
    pred, labels = np.asarray(pred), np.asarray(labels)
    return float(np.mean([float((pred[labels == c] == c).mean())
                          for c in np.unique(labels)]))


def micro_f1(pred: np.ndarray, labels: np.ndarray) -> float:
    """Micro-averaged F1 of binary multi-label predictions (logits > 0)."""
    pred = np.asarray(pred) > 0
    labels = np.asarray(labels) > 0.5
    tp = float(np.logical_and(pred, labels).sum())
    fp = float(np.logical_and(pred, ~labels).sum())
    fn = float(np.logical_and(~pred, labels).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


class IoUAccumulator:
    """Per-class intersection and union counts → mIoU over the classes seen
    (`examples/sem_seg_dense/train.py:104-138`)."""

    def __init__(self, num_classes: int):
        self.i = np.zeros(num_classes, np.int64)
        self.u = np.zeros(num_classes, np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray):
        for c in range(len(self.i)):
            p = pred == c
            lab = label == c
            self.i[c] += int(np.logical_and(p, lab).sum())
            self.u[c] += int(np.logical_or(p, lab).sum())

    def miou(self) -> float:
        valid = self.u > 0
        return float((self.i[valid] / self.u[valid]).mean()) if valid.any() else 0.0


def hits_at_k(pos_scores: np.ndarray, neg_scores: np.ndarray, k: int) -> float:
    """Share of positive edges scored above the k-th best negative (OGB
    link-prediction Hits@K); 1 with fewer than k negatives."""
    neg_sorted = np.sort(np.asarray(neg_scores))[::-1]
    if len(neg_sorted) < k:
        return 1.0
    return float((np.asarray(pos_scores) > neg_sorted[k - 1]).mean())


def part_seg_miou(preds: np.ndarray, labels: np.ndarray, n_classes: int):
    """PartNet protocol (`examples/part_sem_seg/main.py:102-148`): returns
    (mean part IoU, shape mIoU). A shape's IoU averages its classes with a
    non-empty union; the part IoU accumulates I/U per class over all shapes
    and averages the classes other than class 0 ('other')."""
    part_i = np.zeros(n_classes, np.float64)
    part_u = np.zeros(n_classes, np.float64)
    shape_tot, shape_cnt = 0.0, 0
    for p, lab in zip(np.asarray(preds), np.asarray(labels)):
        cur_tot, cur_cnt = 0.0, 0
        for c in range(n_classes):
            inter = float(np.logical_and(p == c, lab == c).sum())
            union = float(np.logical_or(p == c, lab == c).sum())
            if union > 0:
                part_i[c] += inter
                part_u[c] += union
                cur_tot += inter / union
                cur_cnt += 1
        if cur_cnt > 0:
            shape_tot += cur_tot / cur_cnt
            shape_cnt += 1
    shape_miou = shape_tot / shape_cnt if shape_cnt else 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        part_iou = part_i[1:] / part_u[1:]
    mean_part_iou = float(np.nanmean(part_iou)) if len(part_iou) else 0.0
    return mean_part_iou, float(shape_miou)
