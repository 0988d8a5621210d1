"""The gp × tp grid of process groups (counterpart of JAX's `make_mesh`,
`deep_gcns_torch_tpu/parallel/mesh.py:18-24`, with axes ("gp", "tp")).

Rank r = g·T + t sits at (gp index g, tp index t), as JAX's
``np.asarray(devices).reshape((D, T))`` orders the devices: the T ranks of
one gp row share a node shard and split its channels (the tp group), the D
ranks of one tp column hold the D node shards of one channel slice (the gp
group). `make_grid(1, T)` is pure tensor parallelism, `make_grid(D, 1)`
pure spatial parallelism.

`dist.new_group` must be called by every rank of the default group, for
every group, in the same order, even for groups the rank is not in (gloo and
NCCL otherwise wait until the timeout): `make_grid` creates all D tp groups,
then all T gp groups, on every rank, and keeps the two that hold it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class Grid:
    """This rank's place on a D × T grid and its two process groups."""

    gp_size: int
    tp_size: int
    gp_index: int
    tp_index: int
    gp_group: object
    tp_group: object


def make_grid(gp: int, tp: int) -> Grid:
    """Split the default group (of gp·tp ranks) into a gp × tp grid; every
    rank must call this, in the same order as its other collectives."""
    world = dist.get_world_size()
    if gp * tp != world:
        raise ValueError(f"a {gp} x {tp} grid needs {gp * tp} ranks, the world has {world}")
    rank = dist.get_rank()
    g, t = divmod(rank, tp)
    tp_groups = [dist.new_group([gi * tp + ti for ti in range(tp)]) for gi in range(gp)]
    gp_groups = [dist.new_group([gi * tp + ti for gi in range(gp)]) for ti in range(tp)]
    return Grid(gp_size=gp, tp_size=tp, gp_index=g, tp_index=t, gp_group=gp_groups[t],
                tp_group=tp_groups[g])
