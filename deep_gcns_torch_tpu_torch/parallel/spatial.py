"""Spatial (edge-partitioned) parallelism: exact full-graph training over D
ranks (counterpart of `deep_gcns_torch_tpu/parallel/spatial.py:67-767`).

* Nodes are sharded contiguously: rank d owns rows [d·S, (d+1)·S).
* Each rank owns every edge whose receiver it owns (receivers re-indexed to
  the shard, senders global), receiver-sorted with its own CSR.
* Per layer the remote sender rows cross between ranks in one of two ways:

  - **halo**: the host precomputes, per ordered rank pair (p → d), the
    unique senders d's edges need from p. Each layer ships them as one
    `comm.ppermute` per ring offset k (rank p → (p + k) mod D), each offset
    padded to its own largest pair. Each rank's edges are split into a
    local-sender set and a halo-sender set, each receiver-sorted with its
    own CSR; the layer aggregates both and combines them exactly
    (`ops.segment.generalized_aggregate_split`, K1 on each part's sums).
    With ``band="auto"`` the local set also gets a band (`ops.band`), and
    GENConv's softmax and sum families take the spatial × band route: K3 on
    the local band, the halo partial through K1.
  - **allgather**: the whole [D·S, C] table is all-gathered (its backward a
    reduce-scatter), and GENConv aggregates the rank's edges with
    `generalized_aggregate(..., row_ptr=)`: K2's message form for the
    softmax family.

  ``exchange="auto"`` takes the halo when it ships fewer rows per rank per
  layer than the all-gather (Σ pads < (D − 1)·S).

The collectives are blocking: the port does not overlap them with the local
aggregation as XLA's scheduler does for the JAX package.

`SpatialDeeperGCN` is `models.DeeperGCN` with its convolutions replaced, so
its parameters and `state_dict` names are the single-process model's: a
checkpoint of either loads into the other. Its BatchNorms take their
training moments across ranks as JAX's do (`nn.core.sync_batch_norm`).
Where the JAX package's spatial model differs from its single-chip one,
the port follows the single-process model: it casts to ``compute_dtype``
and applies MsgNorm, which JAX's `SpatialDeeperGCN._gcn_apply` skips
(ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..convs.sparse import gather as take
from ..models.deeper_gcn import DeeperGCN, DeeperGCNConfig
from ..nn.core import sync_batch_norm
from ..ops.band import band_spmm, build_band_pair
from ..ops.segment import (generalized_aggregate, generalized_aggregate_split,
                           segment_degree)
from ..ops.spmm_cuda import segment_sum_csr
from ..utils.optim import clip_grad_global_norm_
from . import comm

EXCHANGES = ("auto", "halo", "allgather")


# ---------------------------------------------------------------------------
# host-side sharding
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpatialShards:
    """Every rank's edge shard as host arrays with a leading rank axis, as
    JAX's `SpatialShards` lays them out. Receivers are local rows; senders
    are global ids (combined set), local rows (loc set) or halo-table rows
    (halo set). ``loc_band`` is one `ops.band.BandPair` a rank (windows,
    leftover padding and static counts unified across ranks, as JAX unifies
    them to stack them)."""

    senders: np.ndarray                   # [D, E_pad] int32, global (sentinel D·S)
    receivers: np.ndarray                 # [D, E_pad] int32, local (sentinel S)
    edge_attr: Optional[np.ndarray]       # [D, E_pad, Ce]
    edge_mask: np.ndarray                 # [D, E_pad] bool
    row_ptr: np.ndarray                   # [D, S + 1] int32
    node_mask: np.ndarray                 # [D, S] bool
    senders_ext: Optional[np.ndarray] = None    # [D, E_pad] into [local ‖ halo]
    send_off: Optional[Tuple[np.ndarray, ...]] = None  # k = 1..D-1: [D, pad_k]
    loc_senders: Optional[np.ndarray] = None
    loc_receivers: Optional[np.ndarray] = None
    loc_row_ptr: Optional[np.ndarray] = None
    loc_edge_attr: Optional[np.ndarray] = None
    halo_senders: Optional[np.ndarray] = None
    halo_receivers: Optional[np.ndarray] = None
    halo_row_ptr: Optional[np.ndarray] = None
    halo_edge_attr: Optional[np.ndarray] = None
    loc_band: Optional[List[Any]] = None
    shard_size: int = 0
    num_nodes_padded: int = 0
    off_pads: Tuple[int, ...] = ()

    @property
    def n_dev(self) -> int:
        return self.node_mask.shape[0]

    @property
    def halo_rows_per_device(self) -> int:
        """Rows each rank ships per layer on the halo path (padding included)."""
        return int(sum(self.off_pads))

    def rank(self, d: int, device="cpu") -> "RankShard":
        """Rank ``d``'s shard as tensors on ``device``."""
        dev = torch.device(device)

        def t(a):
            return None if a is None else torch.from_numpy(np.ascontiguousarray(a[d])).to(dev)

        return RankShard(
            senders=t(self.senders), receivers=t(self.receivers), edge_attr=t(self.edge_attr),
            edge_mask=t(self.edge_mask), row_ptr=t(self.row_ptr), node_mask=t(self.node_mask),
            senders_ext=t(self.senders_ext),
            send_off=None if self.send_off is None else tuple(t(a) for a in self.send_off),
            loc_senders=t(self.loc_senders), loc_receivers=t(self.loc_receivers),
            loc_row_ptr=t(self.loc_row_ptr), loc_edge_attr=t(self.loc_edge_attr),
            halo_senders=t(self.halo_senders), halo_receivers=t(self.halo_receivers),
            halo_row_ptr=t(self.halo_row_ptr), halo_edge_attr=t(self.halo_edge_attr),
            loc_band=None if self.loc_band is None else self.loc_band[d].to(dev),
            shard_size=self.shard_size, num_nodes_padded=self.num_nodes_padded,
            off_pads=self.off_pads, index=d)


@dataclass(frozen=True)
class RankShard:
    """One rank's shard as tensors. It carries the attributes the models read
    from a `Graph` (``node_mask``, ``edge_attr``, ``edge_attr_csc``), so
    `DeeperGCN` and `RevGCN` run their row-local stages on it unchanged."""

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_attr: Optional[torch.Tensor]
    edge_mask: torch.Tensor
    row_ptr: torch.Tensor
    node_mask: torch.Tensor
    senders_ext: Optional[torch.Tensor]
    send_off: Optional[Tuple[torch.Tensor, ...]]
    loc_senders: Optional[torch.Tensor]
    loc_receivers: Optional[torch.Tensor]
    loc_row_ptr: Optional[torch.Tensor]
    loc_edge_attr: Optional[torch.Tensor]
    halo_senders: Optional[torch.Tensor]
    halo_receivers: Optional[torch.Tensor]
    halo_row_ptr: Optional[torch.Tensor]
    halo_edge_attr: Optional[torch.Tensor]
    loc_band: Optional[Any]
    shard_size: int
    num_nodes_padded: int
    off_pads: Tuple[int, ...]
    index: int
    edge_attr_csc: Optional[torch.Tensor] = None

    @property
    def total_halo(self) -> int:
        return int(sum(self.off_pads))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _build_loc_band(D, S, dev_start, is_remote_o, s_o, r_o):
    """Each rank's band over its local edge set (JAX `_build_loc_band`,
    `spatial.py:121-163`): one window for all ranks (the largest "auto"
    pick, at least 128), the leftover arrays padded with the sentinel S to
    one length and ``n_edges``/``n_lo`` set to the ranks' largest."""

    def loc_edges(d):
        a, z = dev_start[d], dev_start[d + 1]
        rm = is_remote_o[a:z]
        return s_o[a:z][~rm] - d * S, r_o[a:z][~rm] - d * S

    window = 128
    for d in range(D):
        bp = build_band_pair(*loc_edges(d), S, "auto")
        window = max(window, bp.fwd.window, bp.bwd.window)
    pairs = [build_band_pair(*loc_edges(d), S, window) for d in range(D)]
    lo_pad = max(b.lo_src.shape[0] for p in pairs for b in (p.fwd, p.bwd))
    n_edges = max(b.n_edges for p in pairs for b in (p.fwd, p.bwd))
    n_lo = max(b.n_lo for p in pairs for b in (p.fwd, p.bwd))

    def unify(b):
        cur = b.lo_src.shape[0]
        if cur != lo_pad:
            src = torch.full((lo_pad,), S, dtype=torch.int32)
            dst = torch.full((lo_pad,), S, dtype=torch.int32)
            src[:cur], dst[:cur] = b.lo_src, b.lo_dst
            b = dataclasses.replace(b, lo_src=src, lo_dst=dst)
        return dataclasses.replace(b, n_edges=n_edges, n_lo=n_lo)

    return [dataclasses.replace(p, fwd=unify(p.fwd), bwd=unify(p.bwd)) for p in pairs]


def shard_graph(senders: np.ndarray, receivers: np.ndarray, num_nodes: int, n_dev: int, *,
                edge_attr: Optional[np.ndarray] = None, node_multiple: int = 256,
                edge_multiple: int = 512, halo: bool = True, halo_multiple: int = 8,
                band: str = "off") -> SpatialShards:
    """Every rank's shard (JAX `shard_graph`, `spatial.py:166-336`, array for
    array, by its numpy branch: stable sorts by receiver and by sender). With
    ``halo`` and D > 1 also the per-offset send sets and the local/halo edge
    split; ``band="auto"`` adds each rank's band over its local edges."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    D = n_dev
    S = ((num_nodes + D * node_multiple - 1) // (D * node_multiple)) * node_multiple
    n_pad = S * D

    owner = receivers // S
    sender_owner = senders // S
    order = np.argsort(receivers, kind="stable")
    s_o, r_o = senders[order], receivers[order]
    dev_start = np.searchsorted(r_o, np.arange(D + 1) * S)
    ow_o, so_o = r_o // S, s_o // S
    ea_o = np.asarray(edge_attr)[order] if edge_attr is not None else None
    counts = np.diff(dev_start)
    e_pad = _round_up(max(int(counts.max(initial=0)), 1), edge_multiple)

    S_arr = np.full((D, e_pad), S, np.int32)
    G_arr = np.full((D, e_pad), n_pad, np.int32)
    EA = np.zeros((D, e_pad) + ea_o.shape[1:], ea_o.dtype) if ea_o is not None else None
    EM = np.zeros((D, e_pad), bool)
    RP = np.zeros((D, S + 1), np.int32)
    NM = np.zeros((D, S), bool)
    for d in range(D):
        a, z = dev_start[d], dev_start[d + 1]
        ne = z - a
        G_arr[d, :ne] = s_o[a:z]
        S_arr[d, :ne] = r_o[a:z] - d * S
        EM[d, :ne] = True
        if EA is not None and ne:
            EA[d, :ne] = ea_o[a:z]
        RP[d, 1:] = np.cumsum(np.bincount(r_o[a:z] - d * S, minlength=S))
        lo, hi = d * S, min((d + 1) * S, num_nodes)
        NM[d, :max(hi - lo, 0)] = True

    halo_kw: dict = {}
    off_pads: Tuple[int, ...] = ()
    if halo and D > 1:
        # one sort by (receiver owner d, sender owner p, sender): the unique
        # boundary rows of each ordered pair and each remote edge's rank in
        # its pair's set fall out of first-occurrence cumsums
        o1 = np.argsort(senders, kind="stable")
        order2 = o1[np.argsort(owner[o1], kind="stable")]
        d2, p2, s2 = owner[order2], sender_owner[order2], senders[order2]
        remote = d2 != p2
        d2r, p2r, s2r = d2[remote], p2[remote], s2[remote]
        pair = d2r * D + p2r
        first = np.empty(len(s2r), bool)
        if len(s2r):
            first[0] = True
            first[1:] = (pair[1:] != pair[:-1]) | (s2r[1:] != s2r[:-1])
        uniq_pair, uniq_s = pair[first], s2r[first]
        sizes = np.bincount(uniq_pair, minlength=D * D).reshape(D, D)  # [d, p]

        # round k ships H[p → (p + k) % D] for every p, padded to its own max
        off_pads = tuple(
            _round_up(max(int(max(sizes[(p + k) % D, p] for p in range(D))), 1), halo_multiple)
            for k in range(1, D))
        cum_off = np.concatenate([[0], np.cumsum(off_pads)]).astype(np.int64)
        total_halo = int(cum_off[-1])

        pair_start = np.searchsorted(uniq_pair, np.arange(D * D + 1))
        send_off = [np.zeros((D, pk), np.int32) for pk in off_pads]
        for d in range(D):
            for p in range(D):
                if p == d:
                    continue
                lo, hi = pair_start[d * D + p], pair_start[d * D + p + 1]
                send_off[(d - p) % D - 1][p, :hi - lo] = uniq_s[lo:hi] - p * S

        # a remote edge's halo-table row: cum_off[k-1] + its rank in the set
        uniq_rank = np.cumsum(first) - 1
        rank_in_pair = uniq_rank - pair_start[pair]
        k_edge = (d2r - p2r) % D
        ext = np.empty(len(senders), np.int64)
        idx_remote, idx_local = order2[remote], order2[~remote]
        ext[idx_remote] = S + cum_off[k_edge - 1] + rank_in_pair
        ext[idx_local] = senders[idx_local] - owner[idx_local] * S
        ext_o = ext[order]

        senders_ext = np.full((D, e_pad), S + total_halo, np.int32)
        for d in range(D):
            a, z = dev_start[d], dev_start[d + 1]
            senders_ext[d, :z - a] = ext_o[a:z]

        # the split edge sets, receiver-sorted within each part
        is_remote_o = ow_o != so_o
        n_loc = np.asarray([np.count_nonzero(~is_remote_o[dev_start[d]:dev_start[d + 1]])
                            for d in range(D)])
        n_halo = counts - n_loc
        e_loc_pad = _round_up(max(int(n_loc.max(initial=0)), 1), edge_multiple)
        e_halo_pad = _round_up(max(int(n_halo.max(initial=0)), 1), edge_multiple)
        LS = np.full((D, e_loc_pad), S, np.int32)
        LR = np.full((D, e_loc_pad), S, np.int32)
        LRP = np.zeros((D, S + 1), np.int32)
        HS = np.full((D, e_halo_pad), total_halo, np.int32)
        HR = np.full((D, e_halo_pad), S, np.int32)
        HRP = np.zeros((D, S + 1), np.int32)
        LEA = (np.zeros((D, e_loc_pad) + ea_o.shape[1:], ea_o.dtype)
               if ea_o is not None else None)
        HEA = (np.zeros((D, e_halo_pad) + ea_o.shape[1:], ea_o.dtype)
               if ea_o is not None else None)
        for d in range(D):
            a, z = dev_start[d], dev_start[d + 1]
            rm = is_remote_o[a:z]
            r_loc = r_o[a:z] - d * S
            nl, nh = int((~rm).sum()), int(rm.sum())
            LS[d, :nl] = s_o[a:z][~rm] - d * S
            LR[d, :nl] = r_loc[~rm]
            LRP[d, 1:] = np.cumsum(np.bincount(r_loc[~rm], minlength=S))
            HS[d, :nh] = ext_o[a:z][rm] - S
            HR[d, :nh] = r_loc[rm]
            HRP[d, 1:] = np.cumsum(np.bincount(r_loc[rm], minlength=S))
            if ea_o is not None:
                LEA[d, :nl] = ea_o[a:z][~rm]
                HEA[d, :nh] = ea_o[a:z][rm]

        halo_kw = dict(senders_ext=senders_ext, send_off=tuple(send_off), loc_senders=LS,
                       loc_receivers=LR, loc_row_ptr=LRP, loc_edge_attr=LEA,
                       halo_senders=HS, halo_receivers=HR, halo_row_ptr=HRP,
                       halo_edge_attr=HEA)
        if band == "auto":
            halo_kw["loc_band"] = _build_loc_band(D, S, dev_start, is_remote_o, s_o, r_o)

    return SpatialShards(senders=G_arr, receivers=S_arr, edge_attr=EA, edge_mask=EM,
                         row_ptr=RP, node_mask=NM, shard_size=S, num_nodes_padded=n_pad,
                         off_pads=off_pads, **halo_kw)


def shard_nodes(x: np.ndarray, shards: SpatialShards) -> np.ndarray:
    """[N, ...] → [D, S, ...], zero-padded."""
    S, n_pad = shards.shard_size, shards.num_nodes_padded
    out = np.zeros((n_pad,) + x.shape[1:], x.dtype)
    out[:len(x)] = x
    return out.reshape(n_pad // S, S, *x.shape[1:])


# ---------------------------------------------------------------------------
# boundary exchange (shared with parallel/spatial_rev.py)
# ---------------------------------------------------------------------------

def use_halo(sh, exchange: str = "auto") -> bool:
    """Halo permutes or the all-gather: "auto" takes the halo when it ships
    fewer rows per rank per layer than the all-gather."""
    if exchange == "allgather" or sh.send_off is None:
        return False
    if exchange == "halo":
        return True
    return sh.total_halo < (len(sh.off_pads)) * sh.shard_size


def start_halo_exchange(h_local: torch.Tensor, sh: RankShard,
                        group=None) -> List[torch.Tensor]:
    """One `comm.ppermute` per ring offset k (rank p → (p + k) mod D) of the
    rows ``send_off[k-1]`` names; returns the received blocks in offset
    order. ``group``: the D ranks that hold the node shards (None: the
    default group)."""
    return [comm.ppermute(h_local.index_select(0, idx.long()), k, group)
            for k, idx in enumerate(sh.send_off, start=1)]


def exchange_sources(h_local: torch.Tensor, sh: RankShard, exchange: str = "auto",
                     group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(source table, sender index [E_pad]) of this rank's combined edge set:
    [local ‖ halo blocks] with ``senders_ext``, or the all-gathered table
    with the global ``senders``; the rows cross the ranks of ``group``."""
    if not use_halo(sh, exchange):
        return comm.all_gather(h_local, group), sh.senders
    return (torch.cat([h_local] + start_halo_exchange(h_local, sh, group), 0),
            sh.senders_ext)


# ---------------------------------------------------------------------------
# GENConv on a shard
# ---------------------------------------------------------------------------

_SOFTMAX = ("softmax", "softmax_sg", "softmax_sum")
_SUMS = ("add", "sum", "mean", "power", "power_sum")


def _halo_partial(tab_fn: Callable, xc: torch.Tensor, sh: RankShard):
    """K3 over the local band of ``tab_fn(x)`` plus K1 over the halo edges
    of ``tab_fn(halo rows)`` (JAX `spatial.py:463-470, 509-516`)."""
    parts = start_halo_exchange(xc, sh)
    agg = band_spmm(tab_fn(xc).contiguous(), sh.loc_band)
    p_h = tab_fn(torch.cat(parts, 0))
    xg = take(p_h, sh.halo_senders).contiguous()
    return agg + segment_sum_csr(xg, sh.halo_receivers, sh.halo_row_ptr).to(agg.dtype)


def _band_softmax(conv, xc, sh, t):
    """The spatial × band softmax family (JAX `_band_gcn_aggregate`): the
    packed node table [e·m | e] with one stabilizer for all ranks (the pmax
    of the ranks' channel bounds: every halo row is some rank's local row)."""
    eps, c = conv.eps, xc.shape[1]
    t_f = t.float().reshape(-1)[0]
    ub = comm.pmax(torch.clamp_min(xc.detach().float().amax(0), 0.0) + eps)
    cmax = torch.where(t_f > 0, t_f * ub, t_f * eps).detach()

    def pack(tab):
        mt = torch.relu(tab.float()) + eps
        et = torch.exp(mt * t_f - cmax)
        if not conv.grad_w:
            et = et.detach()
        return torch.cat([et * mt, et], 1).to(xc.dtype)

    agg = _halo_partial(pack, xc, sh)
    num, den = agg[:, :c].float(), agg[:, c:].float()
    pos = den > 0
    m = torch.where(pos, num / torch.where(pos, den, 1.0), 0.0).to(xc.dtype)
    if conv.aggr == "softmax_sum":
        deg = segment_degree(sh.receivers, sh.shard_size, sh.edge_mask)
        m = torch.pow(deg, torch.sigmoid(conv.y))[:, None].to(m.dtype) * m
    return m


def _band_sums(conv, xc, sh):
    """The spatial × band sum family (JAX `_band_sum_aggregate`): the node
    table relu(x) + ε (or its clipped p-th power) through the band and the
    halo partial; mean and power finish per node (receiver-partitioned
    edges make the degrees shard-complete)."""
    eps, cd = conv.eps, xc.dtype
    power = conv.aggr in ("power", "power_sum")
    lo, hi = 1e-7, 1e1

    def tab(t_):
        m_ = torch.relu(t_.float()) + eps
        if power:
            m_ = torch.pow(torch.clamp(m_, lo, hi), conv.p)
        return m_.to(cd)

    s = _halo_partial(tab, xc, sh).float()
    deg = segment_degree(sh.receivers, sh.shard_size, sh.edge_mask)
    mean_div = torch.clamp_min(deg, 1.0)[:, None]
    if conv.aggr == "mean":
        m = s / mean_div
    elif power:
        m = torch.pow(torch.clamp(s / mean_div, lo, hi), 1.0 / conv.p)
        if conv.aggr == "power_sum":
            m = torch.pow(deg, torch.sigmoid(conv.y))[:, None] * m
    else:
        m = s
    return m.to(cd)


def spatial_genconv(conv, x: torch.Tensor, sh: RankShard, edge_emb=None,
                    exchange: str = "auto") -> torch.Tensor:
    """`convs.sparse.GENConv` on rank ``sh``'s rows, its routes in JAX's
    order (`spatial.py:532-611`): the spatial × band families, the halo
    split, the all-gather. ``edge_emb`` is the model-level embedding (a
    (local, halo) pair on the halo route), else the conv's own encoder
    encodes the shard's edge features."""
    cd = conv.compute_dtype
    xc = x.to(cd)
    S = sh.shard_size
    enc = conv.edge_encoder
    t = conv.t if conv.grad_w else conv.t.detach()
    agg_kw = dict(aggr=conv.aggr, t=t, p=conv.p, y=conv.y, learn_t=conv.grad_w)
    halo = use_halo(sh, exchange)
    band = (halo and sh.loc_band is not None and edge_emb is None and enc is None
            and sh.loc_edge_attr is None)
    if band and conv.aggr in _SOFTMAX:
        m = _band_softmax(conv, xc, sh, t)
    elif band and conv.aggr in _SUMS:
        m = _band_sums(conv, xc, sh)
    elif halo:
        parts = start_halo_exchange(xc, sh)
        ee_loc = ee_halo = None
        if isinstance(edge_emb, tuple):
            ee_loc, ee_halo = edge_emb
        elif enc is not None and sh.loc_edge_attr is not None:
            ee_loc, ee_halo = enc(sh.loc_edge_attr), enc(sh.halo_edge_attr)
        eps = torch.tensor(conv.eps, dtype=cd)

        def msgs(tab, idx, ee):
            msg = take(tab, idx)
            if ee is not None:
                msg = msg + ee.to(cd)
            return torch.relu(msg) + eps

        m = generalized_aggregate_split(
            [(msgs(xc, sh.loc_senders, ee_loc), sh.loc_receivers, sh.loc_row_ptr, None),
             (msgs(torch.cat(parts, 0), sh.halo_senders, ee_halo), sh.halo_receivers,
              sh.halo_row_ptr, None)], S, **agg_kw)
    else:
        h_full, senders = exchange_sources(xc, sh, "allgather")
        ee = edge_emb
        if ee is None and enc is not None and sh.edge_attr is not None:
            ee = enc(sh.edge_attr)
        msg = take(h_full, senders)
        if ee is not None:
            msg = msg + ee.to(cd)
        msg = torch.relu(msg) + torch.tensor(conv.eps, dtype=cd)
        m = generalized_aggregate(msg, sh.receivers, S, mask=sh.edge_mask,
                                  row_ptr=sh.row_ptr, **agg_kw)
    m = m.to(x.dtype)
    if conv.msg_norm is not None:
        m = conv.msg_norm(x, m)
    return conv.mlp(x + m, sh.node_mask, cd if cd == torch.bfloat16 else None)


class SpatialDeeperGCN(DeeperGCN):
    """`DeeperGCN` on one rank's shard (JAX `SpatialDeeperGCN`,
    `spatial.py:399-709`): the same parameters and names, res+/res/plain
    blocks, the one-hot input stage, each GENConv exchanging boundary rows
    (`spatial_genconv`), BatchNorm moments across ranks. Called as
    ``model(x_local [S, C], shard, generator, node_feats_local)``; dropout
    draws from the rank's own ``generator``. Graph-pooled and virtual-node
    models batch many small graphs and are refused (use cluster data
    parallelism, `parallel/data_parallel.py`)."""

    def __init__(self, cfg: DeeperGCNConfig, exchange: str = "auto",
                 generator: Optional[torch.Generator] = None):
        if cfg.add_virtual_node or cfg.graph_pooling:
            raise ValueError("graph-pooled / virtual-node models are per-graph batches: use "
                             "parallel.data_parallel instead of spatial partitioning")
        if exchange not in EXCHANGES:
            raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")
        super().__init__(cfg, generator=generator)
        self.exchange = exchange
        sync_batch_norm(self)

    def _model_edge_embeddings(self, sh) -> dict:
        enc = {"one_time": "edge_encoder", "one_time_bond": "bond_encoder"}.get(
            self.cfg.edge_mode)
        if enc is None or sh.edge_attr is None:
            return {}
        encoder = getattr(self, enc)
        if use_halo(sh, self.exchange):
            return {"edge_emb": (encoder(sh.loc_edge_attr), encoder(sh.halo_edge_attr))}
        return {"edge_emb": encoder(sh.edge_attr)}

    def _conv(self, i: int, h: torch.Tensor, sh, ee: dict) -> torch.Tensor:
        return spatial_genconv(self.gcns[i], h, sh, ee.get("edge_emb"), self.exchange)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def masked_nll_sum(logits, labels, mask):
    """(Σ masked cross entropy, masked count) of one shard, each summed as
    `utils.loss.cross_entropy` sums them."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    m = mask.to(nll.dtype)
    return (nll * m).sum(), m.sum()


def masked_bce_sum(logits, targets, mask):
    """(Σ masked multi-task BCE, masked count · tasks) of one shard, in
    `utils.loss.bce_with_logits`'s stable form."""
    targets = torch.nan_to_num(targets)
    per = (torch.clamp_min(logits, 0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    m = mask.to(per.dtype)[:, None].expand(per.shape)
    return (per * m).sum(), m.sum()


def spatial_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, sh: RankShard,
                       x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                       loss_fn: LossFn = masked_nll_sum, *,
                       node_feats: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       max_grad_norm: Optional[float] = None) -> torch.Tensor:
    """One full-graph step on this rank (JAX `spatial_train_step`,
    `spatial.py:732-767`): the shard's (loss sum, count) from ``loss_fn``,
    the counts summed over the ranks (no gradient), this rank's share
    loss_sum / count backpropagated, the parameter gradients summed over the
    ranks, the optional global-norm clip, the update. Backpropagating the
    all-reduced loss on every rank would train with D× the gradient.
    Returns the all-reduced loss (the same on every rank)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(x, sh, generator=generator, node_feats=node_feats)
    ls, cnt = loss_fn(logits, labels, mask)
    tot = comm.all_reduce_sum(torch.stack([ls.detach(), cnt.detach()]))
    denom = torch.clamp_min(tot[1], 1.0)
    (ls / denom).backward()
    params = [p for p in model.parameters() if p.requires_grad]
    comm.all_reduce_grads(params)
    if max_grad_norm is not None:
        clip_grad_global_norm_(params, max_grad_norm)
    opt.step()
    return tot[0] / denom


@torch.no_grad()
def spatial_forward(model: torch.nn.Module, sh: RankShard, x: torch.Tensor,
                    node_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode logits of the whole graph [D·S, T], rank d's rows at
    [d·S, (d+1)·S), on every rank (rank 0 scores them)."""
    model.eval()
    return comm.all_gather(model(x, sh, node_feats=node_feats))


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The rank's dropout stream (JAX folds the device index into the key)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + rank)

