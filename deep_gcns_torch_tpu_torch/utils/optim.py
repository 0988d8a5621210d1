"""Optimizers (counterpart of `deep_gcns_torch_tpu/utils/optim.py`).

`make_optimizer("adam", ...)` is the JAX package's `adam(lr, weight_decay)`:
optax's `adam`, or `adamw` when there is weight decay. torch's Adam and AdamW
place eps and apply the decoupled decay as optax does.
`make_optimizer("rmsprop", ...)` is its torch-exact `rmsprop` (RevGAT,
`utils/optim.py:150-159`): torch's RMSprop with alpha 0.99, eps outside the
square root and coupled weight decay, which is what optax's
`rmsprop(decay=0.99, eps_in_sqrt=False)` chained after
`add_decayed_weights` computes. `linear_schedule` is optax's, for a
`LambdaLR`. `clip_grad_global_norm_` is optax's `clip_by_global_norm`,
which the proteins apps chain before Adam (`examples/proteins_common.py:84`).
The reference-exact radam and adamw variants come with later slices.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                                   weight_decay=weight_decay)
    if name != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet "
                                  "(the port has 'adam' and 'rmsprop')")
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax's `linear_schedule`: the value at update k (k = 0 first) goes
    linearly from ``init_value`` to ``end_value`` over ``transition_steps``
    updates and stays there. With an optimizer built at lr 1.0,
    `torch.optim.lr_scheduler.LambdaLR(opt, linear_schedule(...))` gives
    update k exactly this lr, so a schedule from 0 makes the first update
    exactly zero. No transition steps give ``init_value`` throughout, as
    optax does."""
    def value(k: int) -> float:
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(k, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return value


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
