"""The parallel layer on `torch.distributed` (counterpart of
`deep_gcns_torch_tpu/parallel/`): spatial (edge-partitioned) parallelism,
spatial × reversible, and cluster data parallelism, with the collectives
(`comm`) and the rank launcher (`launch`). Tensor parallelism
(`tensor.py`, `tensor_rev.py`, `spatial_tp.py` of the JAX package) is not
ported yet."""

from .comm import all_gather, all_reduce_sum, init_rank, pmax, ppermute
from .data_parallel import cluster_dp_train_step
from .launch import RankFailed, launch
from .spatial import (RankShard, SpatialDeeperGCN, SpatialShards, shard_graph, shard_nodes,
                      spatial_forward, spatial_train_step)
from .spatial_rev import SpatialRevGCN

__all__ = ["all_gather", "all_reduce_sum", "init_rank", "pmax", "ppermute",
           "cluster_dp_train_step", "RankFailed", "launch", "RankShard", "SpatialDeeperGCN",
           "SpatialShards", "shard_graph", "shard_nodes", "spatial_forward",
           "spatial_train_step", "SpatialRevGCN"]
