"""Spatial (edge-partitioned) reversible GCN (counterpart of
`deep_gcns_torch_tpu/parallel/spatial_rev.py:55-444`): RevGCN's
O(1)-activation-memory reversible stack on one rank's shard, each group
function exchanging its source rows across ranks.

`SpatialRevGCN` is `models.RevGCN` with its group functions replaced by the
spatial twins below, which subclass the single-process blocks: the
parameters and `state_dict` names are RevGCN's, and the forward (one-hot
input stage, the edge encoder on the shard's combined edge set replicated
G times, one shared dropout mask a rank from the rank's generator, the
head) is RevGCN's own, run on a `parallel.spatial.RankShard`. The
reversible engine (`rev/invertible.py`) hands the shard to the couplings as
it hands them a graph; the backward's inverse re-evaluates every group
function and so re-issues its collectives, in the same order on every rank.
The norm must be LayerNorm, as JAX asserts (`:313-314`): BatchNorm's
running statistics would break the exact inverse.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..convs.sparse import gather as take
from ..models.rev_gcn import RevGCN, RevGCNConfig
from ..ops.segment import generalized_aggregate, segment_degree, segment_sum
from ..rev.rev_layer import GATBlock, GCNBlock, GENBlock, SAGEBlock, _pre
from .spatial import EXCHANGES, exchange_sources


class SpatialGENBlock(GENBlock):
    """norm → relu → shared dropout → GENConv with the source gather across
    ranks (JAX `SpatialGENBlock`): the messages of the combined edge set and
    `generalized_aggregate(..., row_ptr=)`, K2's message form for the
    softmax family."""

    exchange = "auto"

    def forward(self, x: torch.Tensor, sh, chunk_args: Tuple = ()) -> torch.Tensor:
        ee_raw = (tuple(chunk_args) + (None, None))[1]
        h = _pre(self.norm, x, sh, chunk_args, self.training)
        gcn = self.gcn
        cd = gcn.compute_dtype
        tab, senders = exchange_sources(h.to(cd), sh, self.exchange)
        msg = take(tab, senders)
        if ee_raw is not None:
            # the conv's own encoder when it has one, else the chunk as it is
            ee = gcn.edge_encoder(ee_raw) if gcn.edge_encoder is not None else ee_raw
            msg = msg + ee.to(cd)
        msg = torch.relu(msg) + torch.tensor(gcn.eps, dtype=cd)
        t = gcn.t if gcn.grad_w else gcn.t.detach()
        m = generalized_aggregate(msg, sh.receivers, sh.shard_size, aggr=gcn.aggr, t=t,
                                  p=gcn.p, y=gcn.y, learn_t=gcn.grad_w, mask=sh.edge_mask,
                                  row_ptr=sh.row_ptr).to(h.dtype)
        if gcn.msg_norm is not None:
            m = gcn.msg_norm(h, m)
        return gcn.mlp(h + m, sh.node_mask, cd if cd == torch.bfloat16 else None)


def _self_edges(sh) -> torch.Tensor:
    """Valid edges whose global sender is their own (global) receiver."""
    gr = sh.receivers.long() + sh.index * sh.shard_size
    return sh.edge_mask & (sh.senders.long() == gr)


class SpatialGCNBlock(GCNBlock):
    """Kipf's GCN on a shard (JAX `SpatialGCNBlock`): the symmetric norm
    factorises per node, so the exchanged payload is dinv·xW; the receiver
    scale and the analytic self loop stay local (edges are partitioned by
    receiver, so degrees are shard-complete)."""

    exchange = "auto"

    def forward(self, x: torch.Tensor, sh, chunk_args: Tuple = ()) -> torch.Tensor:
        S = sh.shard_size
        h = _pre(self.norm, x, sh, chunk_args, self.training)
        conv = self.gcn
        xt = h @ conv.weight
        has_self = torch.clamp_max(segment_degree(sh.receivers, S, _self_edges(sh)), 1.0)
        deg = segment_degree(sh.receivers, S, sh.edge_mask) + (1.0 - has_self)
        dinv = torch.rsqrt(torch.clamp_min(deg, 1.0))
        tab, senders = exchange_sources(dinv[:, None] * xt, sh, self.exchange)
        out = dinv[:, None] * segment_sum(take(tab, senders), sh.receivers, S, sh.edge_mask,
                                          sh.row_ptr)
        out = out + xt * ((1.0 - has_self) * dinv * dinv)[:, None]
        return out if conv.bias is None else out + conv.bias


class SpatialSAGEBlock(SAGEBlock):
    """The reference's SAGE on a shard (JAX `SpatialSAGEBlock`): the
    exchanged payload is xW; the mean over neighbours (self edges excluded)
    and the self term, and the update MLP, are shard-local."""

    exchange = "auto"

    def forward(self, x: torch.Tensor, sh, chunk_args: Tuple = ()) -> torch.Tensor:
        S = sh.shard_size
        h = _pre(self.norm, x, sh, chunk_args, self.training)
        conv = self.gcn
        xt = h @ conv.weight
        tab, senders = exchange_sources(xt, sh, self.exchange)
        emask = sh.edge_mask & ~_self_edges(sh)
        s = segment_sum(take(tab, senders), sh.receivers, S, emask, sh.row_ptr) + xt
        cnt = segment_degree(sh.receivers, S, emask) + 1.0
        out = conv.nn(torch.cat([h, s / cnt[:, None]], 1), sh.node_mask)
        return out if conv.bias is None else out + conv.bias


class SpatialGATBlock(GATBlock):
    """PyG's GATConv without self loops on a shard (JAX `SpatialGATBlock`):
    the score splits per node, so one exchanged payload [xW | s_src] serves
    both the logits and the messages; the segment softmax is receiver-local.
    Heads are averaged."""

    exchange = "auto"

    def forward(self, x: torch.Tensor, sh, chunk_args: Tuple = ()) -> torch.Tensor:
        S = sh.shard_size
        hpre = _pre(self.norm, x, sh, chunk_args, self.training)
        conv = self.gcn
        h, d = conv.heads, conv.out_dim
        xt = (hpre @ conv.gconv.weight).reshape(S, h, d)
        att = conv.gconv.att[0]
        s_dst = (xt * att[:, :d]).sum(-1)
        s_src = (xt * att[:, d:]).sum(-1)
        tab, senders = exchange_sources(torch.cat([xt.reshape(S, h * d), s_src], 1), sh,
                                        self.exchange)
        senders = torch.clamp(senders.long(), max=tab.shape[0] - 1)
        xt_src, ss_src = tab[:, :h * d], tab[:, h * d:]
        emask = sh.edge_mask & ~_self_edges(sh) if conv.self_loops else sh.edge_mask
        recv = torch.clamp(sh.receivers.long(), max=S - 1)
        e_score = torch.nn.functional.leaky_relu(s_dst[recv] + ss_src[senders], conv.neg_slope)
        self_score = torch.nn.functional.leaky_relu(s_dst + s_src, conv.neg_slope)
        neg_inf = float("-inf")
        mx = torch.full((S, h), neg_inf, dtype=e_score.dtype, device=x.device).scatter_reduce(
            0, recv[:, None].expand(-1, h), torch.where(emask[:, None], e_score, neg_inf),
            "amax")
        if conv.self_loops:
            mx = torch.maximum(mx, self_score)
        mx = torch.where(torch.isfinite(mx), mx, 0.0).detach()
        e_exp = torch.where(emask[:, None], torch.exp(e_score - mx[recv]), 0.0)
        denom = segment_sum(e_exp, sh.receivers, S)
        if conv.self_loops:
            self_exp = torch.exp(self_score - mx)
            denom = denom + self_exp
        alpha = e_exp / torch.clamp_min(denom[recv], 1e-16)
        msg = xt_src[senders].reshape(-1, h, d) * alpha[..., None]
        out = segment_sum(torch.where(emask[:, None, None], msg, 0.0), sh.receivers, S)
        if conv.self_loops:
            out = out + xt * (self_exp / torch.clamp_min(denom, 1e-16))[..., None]
        out = out.reshape(S, h * d)
        if conv.gconv.bias is not None:
            out = out + conv.gconv.bias
        return out.reshape(S, h, d).mean(1)


class SpatialRevGCN(RevGCN):
    """`RevGCN` on one rank's shard: called as ``model(x_local, shard,
    node_feats=..., generator=...)``, with the rank's own generator for the
    shared dropout mask and the head's dropout."""

    block_types = {"gen": SpatialGENBlock, "gcn": SpatialGCNBlock,
                   "sage": SpatialSAGEBlock, "gat": SpatialGATBlock}

    def __init__(self, cfg: RevGCNConfig, exchange: str = "auto",
                 generator: Optional[torch.Generator] = None):
        if cfg.norm != "layer":
            raise ValueError("reversible couplings need stateless norms (norm='layer')")
        if exchange not in EXCHANGES:
            raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")
        super().__init__(cfg, generator=generator)
        for layer in self.gcns:
            for fm in layer.Fms:
                fm.exchange = exchange
