"""Graph partitioning for cluster-wise training, the ogbn-proteins workflow
(counterpart of `deep_gcns_torch_tpu/data/partition.py:23-142`, reference
`utils/data_util.py:43-61` and `examples/ogb/ogbn_proteins/dataset.py:111-151`).

A uniform-random (or locality-aware) node partition into k clusters; each
cluster's subgraph keeps its intra-cluster edges only, and every cluster is
padded to one fixed (node_pad, edge_pad) bucket, so one set of shapes serves
every cluster and every epoch. Evaluation averages the predictions of several
partitions (`scatter_predictions`). The arrays are bit for bit the JAX
package's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..graph import Graph, build_graph
from .reorder import cluster_order, invert_permutation


def random_partition_graph(rng: np.random.Generator, num_nodes: int,
                           cluster_number: int = 10) -> np.ndarray:
    """parts[i] = cluster of node i (uniform random, `utils/data_util.py:43-45`)."""
    return rng.integers(0, cluster_number, num_nodes).astype(np.int32)


def locality_partition_graph(rng: np.random.Generator, senders: np.ndarray,
                             receivers: np.ndarray, num_nodes: int,
                             cluster_number: int = 10) -> np.ndarray:
    """Greedy max-connectivity cluster ordering (`data/reorder.cluster_order`)
    cut into ``cluster_number`` contiguous equal chunks at a random rotation,
    with shuffled chunk ids: far more intra-cluster edges than the uniform
    partition keeps, at the same cost per cluster."""
    size = -(-num_nodes // cluster_number)
    perm = cluster_order(senders, receivers, num_nodes, cluster_size=size)
    rank = invert_permutation(np.asarray(perm))
    shift = int(rng.integers(0, num_nodes)) if num_nodes else 0
    parts = ((rank + shift) % num_nodes) // size
    relabel = rng.permutation(cluster_number).astype(np.int32)
    return relabel[np.minimum(parts, cluster_number - 1).astype(np.int64)]


def _cluster_edges_numpy(senders, receivers, parts, cluster_number):
    """(node id lists, per cluster (local senders, local receivers, edge ids))."""
    local_id = np.zeros(parts.shape[0], np.int64)
    node_lists = []
    for c in range(cluster_number):
        ids = np.flatnonzero(parts == c)
        local_id[ids] = np.arange(ids.size)
        node_lists.append(ids)
    same = parts[senders] == parts[receivers]
    cl_edges = []
    for c in range(cluster_number):
        m = same & (parts[senders] == c)
        cl_edges.append((local_id[senders[m]], local_id[receivers[m]], np.flatnonzero(m)))
    return node_lists, cl_edges


def generate_sub_graphs(
    senders: np.ndarray,
    receivers: np.ndarray,
    parts: np.ndarray,
    cluster_number: int,
    *,
    edge_attr: Optional[np.ndarray] = None,
    node_feats: Optional[Sequence[np.ndarray]] = None,
    node_pad: Optional[int] = None,
    edge_pad: Optional[int] = None,
) -> Tuple[List[Graph], List[np.ndarray], List[List[np.ndarray]]]:
    """Split into per-cluster padded Graphs (host tensors).

    Returns (graphs, node_index_lists, per-cluster node feature arrays), where
    node_index_lists[c] holds the original ids of cluster c's rows. The edges
    come from the native library's single pass when it loads, else from the
    numpy version; both give the same arrays."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    nat = native.partition_clusters(senders, receivers, parts, cluster_number)
    if nat is not None:
        cl_edges = nat[2]
        node_lists = [np.flatnonzero(parts == c) for c in range(cluster_number)]
    else:
        node_lists, cl_edges = _cluster_edges_numpy(senders, receivers, parts,
                                                    cluster_number)
    if node_pad is None:
        node_pad = ((max(len(ids) for ids in node_lists) + 255) // 256) * 256
    if edge_pad is None:
        edge_pad = ((max(len(ls) for ls, _, _ in cl_edges) + 511) // 512) * 512

    graphs, feats_out = [], []
    for c in range(cluster_number):
        ls, lr, ei = cl_edges[c]
        ea = edge_attr[ei] if edge_attr is not None else None
        graphs.append(build_graph(None, ls, lr, edge_attr=ea, num_nodes=len(node_lists[c]),
                                  node_pad=node_pad, edge_pad=edge_pad))
        if node_feats is not None:
            padded = []
            for nf in node_feats:
                out = np.zeros((node_pad,) + nf.shape[1:], nf.dtype)
                out[: len(node_lists[c])] = nf[node_lists[c]]
                padded.append(out)
            feats_out.append(padded)
    return graphs, node_lists, feats_out


def scatter_predictions(preds: Sequence[np.ndarray], node_lists: Sequence[np.ndarray],
                        num_nodes: int) -> np.ndarray:
    """Reassemble per-cluster padded predictions into full-graph order."""
    out = np.zeros((num_nodes,) + preds[0].shape[1:], preds[0].dtype)
    for p, ids in zip(preds, node_lists):
        out[ids] = p[: len(ids)]
    return out
