"""The parallel layer on `torch.distributed` (counterpart of
`deep_gcns_torch_tpu/parallel/`): spatial (edge-partitioned) parallelism,
spatial × reversible, cluster data parallelism, and tensor (channel)
parallelism of DeeperGCN and RevGCN, alone or on a gp × tp grid with
spatial parallelism; with the collectives (`comm`), the grid of process
groups (`mesh`) and the rank launcher (`launch`)."""

from .comm import (all_gather, all_reduce_replicated, all_reduce_sum, init_rank, pmax,
                   ppermute, psum_scatter)
from .data_parallel import cluster_dp_train_step
from .launch import RankFailed, launch
from .mesh import Grid, make_grid
from .spatial import (RankShard, SpatialDeeperGCN, SpatialShards, shard_graph, shard_nodes,
                      spatial_forward, spatial_train_step)
from .spatial_rev import SpatialRevGCN
from .spatial_tp import SpatialTPDeeperGCN, spatial_tp_forward, spatial_tp_train_step
from .tensor import (TPDeeperGCN, check_tp_supported, shard_deeper_params, tp_forward,
                     tp_train_step, unshard_deeper_params)
from .tensor_rev import (TPRevGCN, check_tp_rev_supported, make_tp_mask, shard_rev_params,
                         tp_rev_forward, tp_rev_train_step, unshard_rev_params)

__all__ = ["all_gather", "all_reduce_replicated", "all_reduce_sum", "init_rank", "pmax",
           "ppermute", "psum_scatter", "cluster_dp_train_step", "RankFailed", "launch", "Grid",
           "make_grid", "RankShard", "SpatialDeeperGCN", "SpatialShards", "shard_graph",
           "shard_nodes", "spatial_forward", "spatial_train_step", "SpatialRevGCN",
           "SpatialTPDeeperGCN", "spatial_tp_forward", "spatial_tp_train_step", "TPDeeperGCN",
           "check_tp_supported", "shard_deeper_params", "tp_forward", "tp_train_step",
           "unshard_deeper_params", "TPRevGCN", "check_tp_rev_supported", "make_tp_mask",
           "shard_rev_params", "tp_rev_forward", "tp_rev_train_step", "unshard_rev_params"]
