"""Host-side locality reordering (counterpart of
`deep_gcns_torch_tpu/data/reorder.py:25-200`).

After a locality pass each 128-row receiver block's neighbours concentrate in
a contiguous source window, which is what the band route (`ops/band.py`)
needs. Reverse Cuthill-McKee suits mesh-like graphs; the greedy cluster order
recovers community structure in small-world graphs, where RCM's BFS frontier
leaks through long-range edges.

Both run in the native library (`native/graphbuild.cpp`) and fall back to
their numpy versions when it is unavailable. The numpy versions are the JAX
package's fallbacks, line for line; the JAX package tries scipy's RCM between
the two, the port does not.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional, Tuple

import numpy as np

from .. import native


def rcm_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation ``perm[new_id] = old_id`` of the
    symmetrized graph (int64)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    perm = native.rcm_order(senders, receivers, num_nodes)
    if perm is not None:
        return perm.astype(np.int64)
    return _rcm_numpy(senders, receivers, num_nodes)


def _rcm_numpy(senders, receivers, num_nodes: int) -> np.ndarray:
    """Pure-numpy RCM (a per-node Python BFS loop: small graphs only)."""
    s = np.concatenate([senders, receivers]).astype(np.int64)
    r = np.concatenate([receivers, senders]).astype(np.int64)
    order_e = np.argsort(s, kind="stable")
    s, r = s[order_e], r[order_e]
    ptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(ptr, s + 1, 1)
    np.cumsum(ptr, out=ptr)
    degree = np.diff(ptr)
    by_deg = np.argsort(degree, kind="stable")
    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    n_done = 0
    scan = 0
    while n_done < num_nodes:
        while visited[by_deg[scan]]:
            scan += 1
        start = by_deg[scan]
        visited[start] = True
        order[n_done] = start
        n_done += 1
        head = n_done - 1
        while head < n_done:
            u = order[head]
            head += 1
            nbrs = r[ptr[u]:ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                order[n_done:n_done + nbrs.size] = nbrs
                n_done += nbrs.size
    return order[::-1].copy()


def cluster_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
                  cluster_size: int = 4096) -> np.ndarray:
    """Greedy max-connectivity cluster ordering ``perm[new_id] = old_id``
    (int64): grows clusters of ``cluster_size`` nodes by absorbing the
    frontier node with the most edges into the current cluster. For the band,
    clusters 8-16x the window recover more coverage than window-sized ones."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    perm = native.cluster_order(senders, receivers, num_nodes, cluster_size)
    if perm is not None:
        return perm.astype(np.int64)
    return _cluster_numpy(senders, receivers, num_nodes, cluster_size)


def _cluster_numpy(senders, receivers, num_nodes: int, cluster_size: int) -> np.ndarray:
    """Pure-Python fallback (heap-based; small graphs only)."""
    s = np.concatenate([senders, receivers]).astype(np.int64)
    r = np.concatenate([receivers, senders]).astype(np.int64)
    order_e = np.argsort(s, kind="stable")
    s, r = s[order_e], r[order_e]
    ptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(ptr, s + 1, 1)
    np.cumsum(ptr, out=ptr)
    degree = np.diff(ptr)
    by_deg = np.argsort(degree, kind="stable")
    placed = np.zeros(num_nodes, bool)
    score = np.zeros(num_nodes, np.int64)
    epoch = np.full(num_nodes, -1, np.int64)
    out = np.empty(num_nodes, np.int64)
    pos = 0
    scan = 0
    cur = 0
    while pos < num_nodes:
        while placed[by_deg[scan]]:
            scan += 1
        seed = int(by_deg[scan])
        cur += 1
        heap = [(-1, seed)]
        score[seed], epoch[seed] = 1, cur
        cnt = 0
        while cnt < cluster_size and heap:
            neg, u = heapq.heappop(heap)
            if placed[u] or epoch[u] != cur or score[u] != -neg:
                continue
            placed[u] = True
            out[pos] = u
            pos += 1
            cnt += 1
            for w in r[ptr[u]:ptr[u + 1]]:
                w = int(w)
                if placed[w]:
                    continue
                if epoch[w] != cur:
                    epoch[w], score[w] = cur, 0
                score[w] += 1
                heapq.heappush(heap, (-int(score[w]), w))
    return out


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """new_of_old[old_id] = new_id for perm[new_id] = old_id."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def permute_graph(perm: np.ndarray, senders: np.ndarray, receivers: np.ndarray,
                  *arrays: Optional[np.ndarray]) -> Tuple[np.ndarray, ...]:
    """Relabel a graph by ``perm[new_id] = old_id``: returns (senders',
    receivers', *node_arrays'), the node arrays (features, labels, masks)
    row-permuted to the new order. Edge order is kept (`build_graph` sorts)."""
    perm = np.asarray(perm)
    inv = invert_permutation(perm)
    out = [inv[np.asarray(senders)], inv[np.asarray(receivers)]]
    for a in arrays:
        out.append(None if a is None else np.asarray(a)[perm])
    return tuple(out)


def bandwidth_stats(senders: np.ndarray, receivers: np.ndarray) -> Dict[str, float]:
    """Locality diagnostics: max, mean and percentiles of |s - r| over edges."""
    d = np.abs(np.asarray(senders, np.int64) - np.asarray(receivers, np.int64))
    if d.size == 0:
        return {"max": 0.0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    return {
        "max": float(d.max()),
        "mean": float(d.mean()),
        "p50": float(np.percentile(d, 50)),
        "p95": float(np.percentile(d, 95)),
        "p99": float(np.percentile(d, 99)),
    }
