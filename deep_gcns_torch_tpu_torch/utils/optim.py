"""Optimizers (counterpart of `deep_gcns_torch_tpu/utils/optim.py`).

`make_optimizer("adam", ...)` is the JAX package's `adam(lr, weight_decay)`:
optax's `adam`, or `adamw` when there is weight decay. torch's Adam and AdamW
place eps and apply the decoupled decay as optax does. The reference-exact
radam and adamw variants and RMSprop come with later slices.
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
