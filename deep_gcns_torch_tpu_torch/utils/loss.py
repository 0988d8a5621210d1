"""Losses (counterpart of `deep_gcns_torch_tpu/utils/loss.py:22-70`:
`cross_entropy`, `smooth_cross_entropy`, `bce_with_logits` and `kd_loss`)."""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over the (masked) rows; labels are int classes."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         smoothing: float = 0.2,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross entropy against the smoothed target one-hot·(1 − ε) + ε/K
    (`utils/loss.py:32-43`, reference SmoothCrossEntropy)."""
    k = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    target = torch.nn.functional.one_hot(labels.long(), k).to(logp.dtype)
    target = target * (1.0 - smoothing) + smoothing / k
    loss = -(target * logp).sum(-1)
    if mask is None:
        return loss.mean()
    m = mask.to(loss.dtype)
    return (loss * m).sum() / torch.clamp_min(m.sum(), 1.0)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross entropy on logits (`utils/loss.py:46-55`), in the
    JAX package's stable form. NaN targets count as 0; ``mask`` covers rows
    ([N]) and/or single labels ([N, T]), e.g. the `is_labeled` mask of
    NaN-labeled entries."""
    targets = torch.nan_to_num(targets)
    per = (torch.clamp_min(logits, 0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype).reshape(mask.shape + (1,) * (per.ndim - mask.ndim))
    m = m.expand(per.shape)
    return (per * m).sum() / torch.clamp_min(m.sum(), 1.0)


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 0.7, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(teacher ‖ student) of the temperature-softened distributions, times
    T² (RevGAT's self-distillation, `utils/loss.py:58-69`), averaged over the
    (masked) rows."""
    t = temperature
    sp = torch.log_softmax(student_logits / t, dim=-1)
    tp = torch.softmax(teacher_logits / t, dim=-1)
    per = (tp * (torch.log(torch.clamp_min(tp, 1e-12)) - sp)).sum(-1) * (t * t)
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype)
    return (per * m).sum() / torch.clamp_min(m.sum(), 1.0)
