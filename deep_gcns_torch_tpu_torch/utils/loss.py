"""Losses (counterpart of `deep_gcns_torch_tpu/utils/loss.py:22-29, 46-55`:
`cross_entropy` and `bce_with_logits`; the other losses of the JAX package
come with later slices)."""

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
