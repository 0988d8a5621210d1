"""Optimizers (counterpart of `deep_gcns_torch_tpu/utils/optim.py`).

`make_optimizer("adam", ...)` is the JAX package's `adam(lr, weight_decay)`:
optax's `adam`, or `adamw` when there is weight decay. torch's Adam and AdamW
place eps and apply the decoupled decay as optax does. `clip_grad_global_norm_`
is optax's `clip_by_global_norm`, which the proteins apps chain before Adam
(`examples/proteins_common.py:84`). The reference-exact radam and adamw
variants and RMSprop come with later slices.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if name != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (only 'adam')")
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr)


@torch.no_grad()
def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter],
                           max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm`, in place on the gradients: with
    ‖g‖ the L2 norm of all gradients together, every gradient becomes
    (g / ‖g‖) · max_norm when ‖g‖ ≥ max_norm and stays as it is otherwise.
    (`torch.nn.utils.clip_grad_norm_` scales by max_norm / (‖g‖ + 1e-6)
    instead.) Stays on the device: no host sync. Returns ‖g‖."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm
