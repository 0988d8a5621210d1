"""Padded, fixed-shape graph container and its numpy host builders.

Counterpart of `deep_gcns_torch_tpu/graph.py:35-319`, with the same
conventions so that both packages build identical arrays from the same input:

* nodes and edges padded to bucket sizes (multiples of 256 and 1024);
* padded edges have ``senders = receivers = N_pad`` (an out-of-range
  sentinel that sorts after every valid id);
* valid edges sorted by receiver (numpy's stable argsort), with the CSR
  ``row_ptr`` [N_pad + 1];
* the CSC auxiliaries (edges re-sorted by sender): ``csc_perm``,
  ``csc_senders``, ``csc_col_ptr``, ``csc_receivers``, ``edge_attr_csc``;
* beside each pointer array, its rows longest first (``row_order``,
  ``csc_order``): the order in which the fused softmax kernels (K2, K4)
  hand rows to warps, so that a hub's long walk starts in the first wave;
  and ``split_rows``, how many of ``row_order``'s first rows K2 splits over
  warps (`ops.spmm_cuda.k2_split_rows`).

Index arrays are int32 tensors: the CUDA kernels read them as ``int``.
`attach_band` adds the band-dense adjacency (`ops/band.BandPair`) of the
band route (`graph.py:74-77, 277-291` of the JAX package).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.spmm_cuda import k2_split_rows

_TENSOR_FIELDS = ("x", "senders", "receivers", "edge_attr", "node_mask", "edge_mask",
                  "node_graph", "row_ptr", "row_order", "csc_perm", "csc_senders",
                  "csc_col_ptr", "csc_order", "csc_receivers", "edge_attr_csc")


@dataclass(frozen=True)
class Graph:
    """A padded (batched) graph; every array field is a tensor or None."""

    x: Optional[torch.Tensor]            # [N_pad, C] float
    senders: torch.Tensor                # [E_pad] int32, source j
    receivers: torch.Tensor              # [E_pad] int32, target i (sorted)
    edge_attr: Optional[torch.Tensor]    # [E_pad, Ce]
    node_mask: torch.Tensor              # [N_pad] bool
    edge_mask: torch.Tensor              # [E_pad] bool
    n_node: int
    n_edge: int
    node_graph: Optional[torch.Tensor] = None     # [N_pad] int32
    row_ptr: Optional[torch.Tensor] = None        # [N_pad + 1] int32
    csc_perm: Optional[torch.Tensor] = None       # [E_pad] int32
    csc_senders: Optional[torch.Tensor] = None    # [E_pad] int32
    csc_col_ptr: Optional[torch.Tensor] = None    # [N_pad + 1] int32
    csc_receivers: Optional[torch.Tensor] = None  # [E_pad] int32
    edge_attr_csc: Optional[torch.Tensor] = None  # [E_pad, Ce]
    row_order: Optional[torch.Tensor] = None      # [N_pad] int32, with row_ptr
    csc_order: Optional[torch.Tensor] = None      # [N_pad] int32, with csc_col_ptr
    # the rows of row_order's prefix that K2 splits (ops.spmm_cuda.k2_split_rows)
    split_rows: int = 0
    # band-dense adjacency (ops/band.BandPair) of a locality-ordered graph;
    # GENConv routes its aggregation through it when present (band_ok)
    band: Optional[Any] = None
    num_graphs: int = 1

    @property
    def num_nodes_padded(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.edge_mask.shape[0]

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)

    def to(self, device: DeviceLike) -> "Graph":
        """Copy every tensor field to ``device`` (resolved as the entry points
        resolve it: a CUDA request without a card raises)."""
        dev = resolve_device(device)
        moved = {f: getattr(self, f).to(dev) for f in _TENSOR_FIELDS
                 if getattr(self, f) is not None}
        if self.band is not None:
            moved["band"] = self.band.to(dev)
        return self.replace(**moved)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tensor(a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def longest_first(ptr: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """The rows of the ranges ``ptr`` by decreasing length, ties in index
    order, int32."""
    if ptr is None:
        return None
    return np.argsort(ptr[:-1].astype(np.int64) - ptr[1:], kind="stable").astype(np.int32)


def build_graph(
    x: Optional[np.ndarray],
    senders: np.ndarray,
    receivers: np.ndarray,
    *,
    edge_attr: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    node_graph: Optional[np.ndarray] = None,
    num_graphs: int = 1,
    node_pad: Optional[int] = None,
    edge_pad: Optional[int] = None,
    pad_multiple: int = 256,
    edge_pad_multiple: int = 1024,
    sort_edges: bool = True,
    with_row_ptr: bool = True,
    with_csc: bool = True,
) -> Graph:
    """Host-side constructor: sorts edges by receiver, pads to bucket sizes and
    builds the CSR/CSC auxiliaries (tensors on the CPU; move with `.to`)."""
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    n_edge = int(senders.shape[0])
    if num_nodes is None:
        if x is not None:
            num_nodes = int(x.shape[0])
        else:
            num_nodes = int(max(senders.max(initial=-1), receivers.max(initial=-1)) + 1)
    n_node = int(num_nodes)

    if sort_edges and n_edge > 0:
        order = np.argsort(receivers, kind="stable")
        senders = senders[order]
        receivers = receivers[order]
        if edge_attr is not None:
            edge_attr = np.asarray(edge_attr)[order]

    n_pad = node_pad if node_pad is not None else _round_up(max(n_node, 1), pad_multiple)
    e_pad = edge_pad if edge_pad is not None else _round_up(max(n_edge, 1),
                                                            edge_pad_multiple)
    if n_pad < n_node or e_pad < n_edge:
        raise ValueError(f"padding too small: nodes {n_node}>{n_pad} or edges {n_edge}>{e_pad}")

    def pad_rows(a: Optional[np.ndarray], rows: int):
        if a is None:
            return None
        a = np.asarray(a)
        out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    sentinel = np.int32(n_pad)
    s_p = np.full((e_pad,), sentinel, np.int32)
    r_p = np.full((e_pad,), sentinel, np.int32)
    s_p[:n_edge] = senders
    r_p[:n_edge] = receivers

    node_mask = np.zeros((n_pad,), bool)
    node_mask[:n_node] = True
    edge_mask = np.zeros((e_pad,), bool)
    edge_mask[:n_edge] = True

    ng = None
    if node_graph is not None:
        ng = np.full((n_pad,), np.int32(num_graphs), np.int32)
        ng[:n_node] = np.asarray(node_graph, np.int32)[:n_node]

    rp = None
    if with_row_ptr:
        counts = np.bincount(receivers[:n_edge], minlength=n_pad).astype(np.int64)
        rp = np.zeros((n_pad + 1,), np.int64)
        np.cumsum(counts[:n_pad], out=rp[1:])
        rp = rp.astype(np.int32)

    csc_perm = csc_senders = csc_col_ptr = csc_receivers = edge_attr_csc = None
    if with_csc and n_edge > 0:
        order = np.argsort(senders[:n_edge], kind="stable").astype(np.int32)
        ss = senders[order]
        cp = np.zeros(n_node + 1, np.int64)
        np.cumsum(np.bincount(ss, minlength=n_node), out=cp[1:])
        cp = cp.astype(np.int32)
        csc_perm = np.full((e_pad,), e_pad - 1, np.int32)
        csc_perm[:n_edge] = order
        csc_senders = np.full((e_pad,), sentinel, np.int32)
        csc_senders[:n_edge] = ss
        csc_col_ptr = np.empty((n_pad + 1,), np.int32)
        csc_col_ptr[: n_node + 1] = cp
        csc_col_ptr[n_node + 1:] = cp[-1]
        csc_receivers = np.full((e_pad,), sentinel, np.int32)
        csc_receivers[:n_edge] = receivers[order]
        if edge_attr is not None:
            ea = np.asarray(edge_attr)
            edge_attr_csc = np.zeros((e_pad,) + ea.shape[1:], ea.dtype)
            edge_attr_csc[:n_edge] = ea[order]

    return Graph(
        x=_tensor(None if x is None else pad_rows(np.asarray(x), n_pad)),
        senders=_tensor(s_p),
        receivers=_tensor(r_p),
        edge_attr=_tensor(pad_rows(edge_attr, e_pad)),
        node_mask=_tensor(node_mask),
        edge_mask=_tensor(edge_mask),
        n_node=n_node,
        n_edge=n_edge,
        node_graph=_tensor(ng),
        row_ptr=_tensor(rp),
        row_order=_tensor(longest_first(rp)),
        split_rows=k2_split_rows(rp),
        csc_perm=_tensor(csc_perm),
        csc_senders=_tensor(csc_senders),
        csc_col_ptr=_tensor(csc_col_ptr),
        csc_order=_tensor(longest_first(csc_col_ptr)),
        csc_receivers=_tensor(csc_receivers),
        edge_attr_csc=_tensor(edge_attr_csc),
        num_graphs=num_graphs,
    )


def batch_graphs(
    graphs: Sequence[dict],
    *,
    node_pad: Optional[int] = None,
    edge_pad: Optional[int] = None,
    pad_multiple: int = 256,
    with_row_ptr: bool = True,
) -> Graph:
    """Block-diagonal batch of raw host graphs (PyG `Batch.from_data_list`
    semantics). Each element is a dict with ``senders``, ``receivers`` and
    optionally ``x``, ``edge_attr`` and ``num_nodes``."""
    xs, ss, rs, eas, gids = [], [], [], [], []
    off = 0
    for g_i, g in enumerate(graphs):
        n = int(g["num_nodes"]) if "num_nodes" in g else int(np.asarray(g["x"]).shape[0])
        if "x" in g and g["x"] is not None:
            xs.append(np.asarray(g["x"]))
        ss.append(np.asarray(g["senders"], np.int64) + off)
        rs.append(np.asarray(g["receivers"], np.int64) + off)
        if g.get("edge_attr") is not None:
            eas.append(np.asarray(g["edge_attr"]))
        gids.append(np.full((n,), g_i, np.int32))
        off += n
    return build_graph(
        np.concatenate(xs, 0) if xs else None,
        np.concatenate(ss, 0),
        np.concatenate(rs, 0),
        edge_attr=np.concatenate(eas, 0) if eas else None,
        num_nodes=off,
        node_graph=np.concatenate(gids, 0),
        num_graphs=len(graphs),
        node_pad=node_pad,
        edge_pad=edge_pad,
        pad_multiple=pad_multiple,
        with_row_ptr=with_row_ptr,
    )


def attach_band(g: Graph, window="auto", hubs="auto") -> Graph:
    """Build the band-dense adjacency of the graph's valid edges
    (`ops/band.build_band_pair`) and attach it. It pays on locality-ordered
    graphs (run `data.reorder.cluster_order` or `rcm_order` first);
    ``g.band.fwd.coverage`` is the fraction of edges carried gather-free, and
    ``hubs="auto"`` moves degree-≥256 nodes into dense hub products. Call on
    the host graph, then move it with `.to`; ``g.replace(band=None)`` strips
    it again."""
    from .ops.band import build_band_pair

    n_edge = int(g.n_edge)
    senders = g.senders[:n_edge].cpu().numpy()
    receivers = g.receivers[:n_edge].cpu().numpy()
    pair = build_band_pair(senders, receivers, g.num_nodes_padded, window, hubs)
    return g.replace(band=pair)


def add_self_loops(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
                   remove_existing: bool = True):
    """Optionally drop existing self loops, then append one per node."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if remove_existing:
        keep = senders != receivers
        senders, receivers = senders[keep], receivers[keep]
    loop = np.arange(num_nodes, dtype=np.int64)
    return np.concatenate([senders, loop]), np.concatenate([receivers, loop])


def to_undirected(senders: np.ndarray, receivers: np.ndarray):
    """Symmetrize and deduplicate an edge list."""
    s = np.concatenate([senders, receivers]).astype(np.int64)
    r = np.concatenate([receivers, senders]).astype(np.int64)
    n = max(int(s.max(initial=0)), int(r.max(initial=0))) + 1
    _, idx = np.unique(s * n + r, return_index=True)
    return s[idx], r[idx]
