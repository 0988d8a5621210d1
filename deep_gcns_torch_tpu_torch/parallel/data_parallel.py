"""Cluster data parallelism: each rank trains one cluster (counterpart of
`deep_gcns_torch_tpu/parallel/data_parallel.py:31-84`, which replaces the
reference's sequential cluster loop, `examples/ogb_eff/ogbn_proteins/
main.py:203-207`, by D clusters at once).

The step is the sequential mean of the D cluster losses: each rank
backpropagates its own cluster's loss, the gradients are summed over the
ranks and divided by D, the reported loss is the ranks' mean, and the
BatchNorms take their moments across the ranks (`nn.core.sync_batch_norm`,
JAX's ``axis_name``). JAX's note at `data_parallel.py:63-70` records the trap
this avoids: a mean of already-summed gradients trains with D× gradients.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..nn.core import sync_batch_norm
from ..utils.optim import clip_grad_global_norm_
from . import comm


def cluster_dp_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, g,
                          x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                          loss_fn: Callable, *, node_feats: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          max_grad_norm: Optional[float] = None) -> torch.Tensor:
    """One step on this rank's cluster ``g``; ``loss_fn(logits, labels,
    mask)`` is the cluster's mean loss. Every rank's model starts from the
    same parameters and stays in step with the others. Returns the ranks'
    mean loss."""
    sync_batch_norm(model)
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model(x, g, generator=generator, node_feats=node_feats), labels, mask)
    loss.backward()
    d = comm.world_size()
    params = [p for p in model.parameters() if p.requires_grad]
    comm.all_reduce_grads(params, scale=1.0 / d)
    if max_grad_norm is not None:
        clip_grad_global_norm_(params, max_grad_norm)
    opt.step()
    return comm.all_reduce_sum(loss.detach()) / d
