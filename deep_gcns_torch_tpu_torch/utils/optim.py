"""Optimizers (counterpart of `deep_gcns_torch_tpu/utils/optim.py`).

`make_optimizer("adam", ...)` is the JAX package's `adam(lr, weight_decay)`:
optax's `adam`, or `adamw` when there is weight decay. torch's Adam and AdamW
place eps and apply the decoupled decay as optax does. `make_optimizer("adamw",
...)` is the apps' `adamw_warmup(lr, warmup_steps=0, weight_decay)`
(`examples/common.py:61-62`): AdamW whose first update has lr 0 (optax's
one-step linear warm-up) and every later one ``lr``; the optimizer sets each
update's lr from its own step count, so it needs no scheduler stepped beside
it and resumes exactly from its `state_dict`.
`make_optimizer("rmsprop", ...)` is its torch-exact `rmsprop` (RevGAT,
`utils/optim.py:150-159`): torch's RMSprop with alpha 0.99, eps outside the
square root and coupled weight decay, which is what optax's
`rmsprop(decay=0.99, eps_in_sqrt=False)` chained after
`add_decayed_weights` computes. `linear_schedule` is optax's, for a
`LambdaLR`. `clip_grad_global_norm_` is optax's `clip_by_global_norm`,
which the proteins apps chain before Adam (`examples/proteins_common.py:84`).

The reference-exact optimizers of `utils/optim.py` (lightaime/deep_gcns_torch
`utils/optim.py:76-205`), as the JAX package transcribes them: `RAdamRef`
(`_scale_by_radam_ref` and `radam`, `optim.py:26-78`) and `AdamWRef`
(`adamw_ref`, `:97-133`, its quirk kept: the warm-up scales only the weight
decay). The schedules `adamw_warmup`, `sgd_cosine` and `sgd_step`
(`:81, 136, 143`) return an optimizer built at lr 1.0 and a `LambdaLR` whose
value at update k is optax's schedule at k; step it after each
`optimizer.step()`. `ReduceLROnPlateau` (`:170-195`) is the same host-side
scale.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch

Scheduled = Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                                   weight_decay=weight_decay)
    if name == "radam":
        return RAdamRef(params, lr=lr, weight_decay=weight_decay)
    if name == "adamw_ref":
        return AdamWRef(params, lr=lr, weight_decay=weight_decay)
    if name == "adamw":
        return _with_schedule(torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay),
                              linear_schedule(0.0, lr, 1))
    if name != "adam":
        raise ValueError(f"unknown optimizer {name!r} (the port has 'adam', 'adamw', "
                         "'radam', 'adamw_ref' and 'rmsprop')")
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


class RAdamRef(torch.optim.Optimizer):
    """The reference's RAdam, update for update: with N_sma the length of
    the approximated simple moving average at step t,

        p ← p − wd·lr·p                                  (decoupled, lr-scaled)
        N_sma ≥ 5: p ← p − lr·r_t/(1 − β1ᵗ) · m/(√v + eps)   (eps outside the
                                                         bias correction)
        else:      p ← p − lr/(1 − β1ᵗ) · m              (un-rectified momentum)
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            n_sma_max = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t, m, v, g = st["step"], st["exp_avg"], st["exp_avg_sq"], p.grad
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                m.mul_(b1).add_(g, alpha=1 - b1)
                beta2_t = b2 ** t
                n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
                if wd:
                    p.add_(p, alpha=-wd * lr)
                if n_sma >= 5:
                    rect = math.sqrt((1 - beta2_t) * (n_sma - 4) / (n_sma_max - 4)
                                     * (n_sma - 2) / n_sma * n_sma_max / (n_sma_max - 2))
                    p.addcdiv_(m, v.sqrt().add_(eps), value=-lr * rect / (1 - b1 ** t))
                else:
                    p.add_(m, alpha=-lr / (1 - b1 ** t))
        return loss


class AdamWRef(torch.optim.Optimizer):
    """The reference's AdamW, quirk kept: the warm-up schedule scales only
    the weight decay, the step uses the raw lr,

        p ← p − wd·lr_t·p − lr·√(1 − β2ᵗ)/(1 − β1ᵗ) · m/(√v + eps),
        lr_t = 1e-8 + t·lr/warmup while t < warmup, else lr.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, warmup: int = 0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      warmup=warmup))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps, warmup = (group["lr"], group["weight_decay"], group["eps"],
                                   group["warmup"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t, m, v, g = st["step"], st["exp_avg"], st["exp_avg_sq"], p.grad
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                m.mul_(b1).add_(g, alpha=1 - b1)
                sched_lr = 1e-8 + t * lr / warmup if warmup > t else lr
                step_size = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
                if wd:
                    p.add_(p, alpha=-wd * sched_lr)
                p.addcdiv_(m, v.sqrt().add_(eps), value=-step_size)
        return loss


def _with_schedule(opt: torch.optim.Optimizer,
                   sched: Callable[[int], float]) -> torch.optim.Optimizer:
    """``opt`` with update k (k = 0 first) taken at lr ``sched(k)``, k read
    from the optimizer's own step count: set before the first update, after
    each update and after `load_state_dict`, so a resumed run continues the
    schedule where the saved one stopped."""
    def sync(*_):
        steps = [st["step"] for st in opt.state.values() if "step" in st]
        k = int(max(float(s) for s in steps)) if steps else 0
        for grp in opt.param_groups:
            grp["lr"] = sched(k)

    sync()
    opt.register_step_post_hook(sync)
    opt.register_load_state_dict_post_hook(sync)
    return opt


def _scheduled(opt: torch.optim.Optimizer, sched: Callable[[int], float]) -> Scheduled:
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


def adamw_warmup(params, lr: float, warmup_steps: int, total_steps: Optional[int] = None,
                 weight_decay: float = 0.01) -> Scheduled:
    """optax's `adamw` on a linear warm-up from 0 to ``lr`` over
    max(warmup_steps, 1) updates, then, with ``total_steps``, a linear decay
    to 0 at ``total_steps`` (so with no warm-up the first update is 0, as in
    the JAX package)."""
    w = max(warmup_steps, 1)
    up = linear_schedule(0.0, lr, w)

    def sched(k: int) -> float:
        if total_steps is None or total_steps <= warmup_steps or k < w:
            return up(k)
        return linear_schedule(lr, 0.0, total_steps - warmup_steps)(k - w)

    return _scheduled(torch.optim.AdamW(params, lr=1.0, weight_decay=weight_decay), sched)


def sgd_cosine(params, lr: float, total_steps: int, momentum: float = 0.9,
               weight_decay: float = 1e-4, min_lr: float = 0.0) -> Scheduled:
    """SGD with momentum and coupled weight decay on optax's
    `cosine_decay_schedule(lr, total_steps, alpha=min_lr/lr)`."""
    steps = max(total_steps, 1)
    alpha = min_lr / lr if lr else 0.0

    def sched(k: int) -> float:
        cos = 0.5 * (1 + math.cos(math.pi * min(k, steps) / steps))
        return lr * ((1 - alpha) * cos + alpha)

    return _scheduled(torch.optim.SGD(params, lr=1.0, momentum=momentum,
                                      weight_decay=weight_decay), sched)


def sgd_step(params, lr: float, step_size: int, gamma: float = 0.5, momentum: float = 0.9,
             weight_decay: float = 1e-4) -> Scheduled:
    """SGD with momentum and coupled weight decay on optax's staircase
    `exponential_decay(lr, step_size, gamma)`: lr·γ^⌊k/step_size⌋."""
    return _scheduled(torch.optim.SGD(params, lr=1.0, momentum=momentum,
                                      weight_decay=weight_decay),
                      lambda k: lr * gamma ** (k // step_size))


class ReduceLROnPlateau:
    """Host-side plateau control (PPI, `examples/ppi/main.py:25`): `step`
    takes the epoch's metric and returns the scale to apply to the base lr,
    multiplied by ``factor`` after more than ``patience`` epochs without a
    better metric (never below ``min_lr``)."""

    def __init__(self, factor: float = 0.5, patience: int = 10, mode: str = "max",
                 min_lr: float = 0.0):
        self.factor, self.patience, self.mode, self.min_lr = factor, patience, mode, min_lr
        self.best = None
        self.bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        better = (self.best is None or
                  (metric > self.best if self.mode == "max" else metric < self.best))
        if better:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.bad = 0
        return self.scale
