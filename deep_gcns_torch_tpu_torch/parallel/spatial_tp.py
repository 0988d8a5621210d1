"""Spatial × tensor parallelism on a (gp × tp) grid (counterpart of
`deep_gcns_torch_tpu/parallel/spatial_tp.py:1-229`): the nodes are split
over the D ranks of a gp group, the channels over the T ranks of a tp group
(`parallel.mesh.make_grid`, rank g·T + t).

* Each gp row holds one node shard (`spatial.shard_graph`) and its
  incoming edges. Per layer the source rows cross the gp group only,
  through `spatial.exchange_sources`: the halo ppermutes or the all-gather
  of [S, C/T] rows (TP ships T× fewer bytes a row than the 1-D spatial
  layer). They are gathered as materialised messages into
  `generalized_aggregate` with the shard's ``row_ptr`` (JAX `:70-75`): K2's
  message form for the softmax family. This is not the port's spatial ×
  band composition, which JAX's 2-D model does not use.
* Over tp everything is `parallel.tensor`'s: the row-parallel MLP with one
  `psum_scatter` a Linear, the packed-moment LayerNorm, the head summed
  into logits every tp rank shares.
* BatchNorm's moments (the inter-layer norms and the MLP's) are taken across
  gp only, with JAX's equal weights (`bn_axis=self.gp`, `:106-108,
  127-129`); channels are never reduced.

The loss of `spatial_tp_train_step` is this shard's sum over the gp-summed
count, as in `spatial.spatial_train_step`; every gradient is then summed
over gp (JAX's transpose does it implicitly, `:182-186`), and the
replicated leaves' gradients over tp.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..convs.sparse import gather as take
from ..models.deeper_gcn import DeeperGCNConfig
from ..nn.core import sync_batch_norm
from . import comm
from .mesh import Grid
from .spatial import EXCHANGES, LossFn, RankShard, exchange_sources, masked_nll_sum
from .tensor import TPDeeperGCN


class SpatialTPDeeperGCN(TPDeeperGCN):
    """`TPDeeperGCN` on one node shard of a gp × tp grid (JAX
    `SpatialTPDeeperGCN`): called as ``model(x_local [S, Cin], shard,
    generator)``; the logits [S, tasks] of the shard's rows, the same on
    every rank of its tp group."""

    def __init__(self, cfg: DeeperGCNConfig, grid: Grid, exchange: str = "auto",
                 generator: Optional[torch.Generator] = None):
        if exchange not in EXCHANGES:
            raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")
        super().__init__(cfg, grid.tp_group, generator=generator)
        self.grid, self.exchange = grid, exchange
        self.gp_group = grid.gp_group
        sync_batch_norm(self, grid.gp_group)

    def _conv(self, i: int, h: torch.Tensor, sh: RankShard) -> torch.Tensor:
        conv = self.gcns[i]
        tab, senders = exchange_sources(h.to(conv.compute_dtype), sh, self.exchange,
                                        self.gp_group)
        m = conv.aggregate(take(tab, senders), sh.receivers, sh.shard_size, sh.edge_mask,
                           sh.row_ptr)
        return conv.update(h, m, sh.node_mask)


def spatial_tp_train_step(model: SpatialTPDeeperGCN, opt: torch.optim.Optimizer,
                          sh: RankShard, x: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor, loss_fn: LossFn = masked_nll_sum, *,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One full-graph step on this rank (JAX `spatial_tp_train_step`): the
    shard's (loss sum, count), the counts summed over gp, this rank's share
    loss_sum / count backpropagated, every gradient summed over gp, the
    replicated leaves' gradients over tp, the update. Returns the loss (the
    same on every rank)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    ls, cnt = loss_fn(model(x, sh, generator), labels, mask)
    tot = comm.all_reduce_sum(torch.stack([ls.detach(), cnt.detach()]), model.gp_group)
    denom = torch.clamp_min(tot[1], 1.0)
    (ls / denom).backward()
    comm.all_reduce_grads(model.parameters(), group=model.gp_group)
    comm.all_reduce_grads(model.replicated_parameters(), group=model.tp_group)
    opt.step()
    return tot[0] / denom


@torch.no_grad()
def spatial_tp_forward(model: SpatialTPDeeperGCN, sh: RankShard, x: torch.Tensor
                       ) -> torch.Tensor:
    """Eval-mode logits of the whole graph [D·S, tasks], gp row d's rows at
    [d·S, (d+1)·S), on every rank."""
    model.eval()
    return comm.all_gather(model(x, sh), model.gp_group)
