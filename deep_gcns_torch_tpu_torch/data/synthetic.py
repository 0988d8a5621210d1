"""Synthetic graph generators (counterpart of
`deep_gcns_torch_tpu/data/synthetic.py:15-87`).

Pure numpy on the caller's `np.random.Generator`, drawing in the same order
as the JAX package, so the same seed gives the same graph in both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..graph import Graph, add_self_loops, build_graph, to_undirected


def random_node_graph(rng: np.random.Generator, n: int, avg_degree: int, c: int,
                      num_classes: int = 0, edge_dim: int = 0,
                      node_pad: Optional[int] = None, edge_pad: Optional[int] = None,
                      self_loops: bool = False, undirected: bool = False,
                      with_row_ptr: bool = True):
    """Uniform random graph with features (and labels); returns (Graph, labels)."""
    e = n * avg_degree
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    if undirected:
        s, r = to_undirected(s, r)
    if self_loops:
        s, r = add_self_loops(s, r, n)
    x = rng.standard_normal((n, c)).astype(np.float32)
    ea = rng.standard_normal((len(s), edge_dim)).astype(np.float32) if edge_dim else None
    g = build_graph(x, s, r, edge_attr=ea, num_nodes=n, node_pad=node_pad,
                    edge_pad=edge_pad, with_row_ptr=with_row_ptr)
    labels = rng.integers(0, num_classes, n) if num_classes else None
    return g, labels


def sbm_arxiv_like(rng: np.random.Generator, n: int = 4096, num_classes: int = 16,
                   c: int = 32, avg_degree: int = 12, homophily: float = 0.9,
                   node_pad: Optional[int] = None, edge_pad: Optional[int] = None
                   ) -> Tuple[Graph, np.ndarray]:
    """Stochastic-block-model node classification task with a learnable
    signal (the stand-in for ogbn-arxiv when no dataset is at hand)."""
    labels = rng.integers(0, num_classes, n)
    centers = rng.standard_normal((num_classes, c)).astype(np.float32)
    x = centers[labels] + 1.5 * rng.standard_normal((n, c)).astype(np.float32)
    e = n * avg_degree
    src = rng.integers(0, n, e)
    same = rng.random(e) < homophily
    by_class = {k: np.flatnonzero(labels == k) for k in range(num_classes)}
    dst = rng.integers(0, n, e)
    for k, idx in by_class.items():
        m = same & (labels[src] == k)
        if idx.size and m.any():
            dst[m] = idx[rng.integers(0, idx.size, int(m.sum()))]
    s, r = to_undirected(src, dst)
    s, r = add_self_loops(s, r, n)
    g = build_graph(x, s, r, num_nodes=n, node_pad=node_pad, edge_pad=edge_pad)
    return g, labels


def powerlaw_community_edges(rng: np.random.Generator, n: int, avg_degree: int,
                             n_comm: int = 256, homophily: float = 0.9,
                             alpha: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """Hub-heavy community graph (a citation/social graph stand-in, the
    realistic shape for the band route): sender weights follow a shuffled
    power law of exponent ``alpha`` (at 0.8 and arxiv scale the top 512
    senders carry ~25% of the edges); receivers stay in the sender's
    community with probability ``homophily`` and are uniform otherwise.
    Node ids arrive shuffled: recover the layout with
    `data.reorder.cluster_order` before attaching a band."""
    e = n * avg_degree
    comm = rng.integers(0, n_comm, n)
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** alpha
    rng.shuffle(w)
    s = rng.choice(n, e, p=w / w.sum())
    r = rng.integers(0, n, e)
    same = rng.random(e) < homophily
    # the homophilous edges and the nodes of each community, bucketed once in
    # id order, so community k draws exactly what a per-k mask would give it
    sel = np.flatnonzero(same)
    cs = comm[s[sel]]
    edges = sel[np.argsort(cs, kind="stable")]
    e_lo = np.searchsorted(np.sort(cs), np.arange(n_comm + 1))
    nodes = np.argsort(comm, kind="stable")
    n_lo = np.searchsorted(comm[nodes], np.arange(n_comm + 1))
    for k in range(n_comm):
        m = edges[e_lo[k]:e_lo[k + 1]]
        idx = nodes[n_lo[k]:n_lo[k + 1]]
        if m.size and idx.size:
            r[m] = idx[rng.integers(0, idx.size, m.size)]
    return s.astype(np.int64), r.astype(np.int64)
