"""GENConv, MsgNorm and the PyG-1.x GATConv (counterpart of
`deep_gcns_torch_tpu/convs/sparse.py:55-247, 342-468`).

Routing of the aggregation, in the JAX package's order
(`convs/sparse.py:167-236`):

* without edge embeddings and with a band attached that passes `band_ok`
  (`ops/band.py`), the softmax family goes to `band_softmax_agg_auto` (K3,
  K1 for the leftover, dense hub products) and add, sum, mean, power and
  power_sum to `band_sum_auto` on a node table;
* otherwise the softmax family (softmax, softmax_sg, softmax_sum) goes to
  `fused_softmax_gather_agg`, which launches K2 in the forward and K1 in the
  backward, or, with edge embeddings in both edge orders, K2 with `ee` and
  K4;
* every other aggregator (max and min always), and the softmax family with
  edge embeddings that lack their sender-ordered copy, gathers the messages
  relu(x_j [+ e]) + ε and runs the plain `generalized_aggregate`.

GATConv scores s_ij = leaky_relu(a_l·x_i + a_r·x_j) per head, a
destination score, so on a band that passes `band_gat_dense_ok` it takes the
dense route (`band_gat_dense_agg`: K7 forward, K8 and K9 backward), and
otherwise the per-edge segment softmax with a combined per-receiver maximum.

On a CPU tensor every kernel runs its plain version. The band max/min
route (`band_extreme`) belongs to a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..graph import Graph
from ..nn.core import MLP, Linear, MultiEmbedding, PReLU, act_layer, make_norm
from ..ops.band import (BAND_SOFTMAX_AGGRS, band_gat_dense_agg, band_gat_dense_ok, band_ok,
                        band_softmax_agg_auto, band_sum_auto)
from ..ops.gather import gather_src_auto
from ..ops.segment import generalized_aggregate, segment_degree, segment_sum
from ..ops.spmm_cuda import fused_softmax_gather_agg_auto

SOFTMAX_AGGRS = ("softmax", "softmax_sg", "softmax_sum")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MsgNorm(nn.Module):
    """msg / ‖msg‖ · ‖x‖ · s (reference `torch_message.py:88-99`)."""

    def __init__(self, learn_msg_scale: bool = False):
        super().__init__()
        self.msg_scale = nn.Parameter(torch.ones(1), requires_grad=learn_msg_scale)

    def forward(self, x: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        msg = msg / torch.clamp_min(torch.linalg.norm(msg, dim=1, keepdim=True), 1e-12)
        return msg * torch.linalg.norm(x, dim=1, keepdim=True) * self.msg_scale


def _scalar(module: nn.Module, name: str, value: float, learned: bool):
    """A learned scalar is a parameter (reference `state_dict` name); a fixed
    one a non-persistent buffer, so that it lives on the model's device."""
    v = torch.tensor([value], dtype=torch.float32)
    if learned:
        module.register_parameter(name, nn.Parameter(v))
    else:
        module.register_buffer(name, v, persistent=False)


class GENConv(nn.Module):
    """DeeperGCN generalized conv: msg = relu(x_j [+ e]) + ε, generalized
    softmax / power-mean aggregation, update h = MLP(x + m). With
    ``encode_edge`` it owns the edge encoder under the reference's name
    `edge_encoder`: Linear(edge_feat_dim, in_dim), or with ``bond_encoder``
    the BondEncoder, a sum of embeddings of the integer bond features
    (`MultiEmbedding(bond_feature_dims, in_dim)`, JAX
    `convs/sparse.py:103-109`)."""

    def __init__(self, in_dim: int, emb_dim: int, aggr: str = "softmax",
                 t: float = 1.0, learn_t: bool = False, p: float = 1.0,
                 learn_p: bool = False, y: float = 0.0, learn_y: bool = False,
                 msg_norm: bool = False, learn_msg_scale: bool = True,
                 encode_edge: bool = False, bond_encoder: bool = False,
                 edge_feat_dim: Optional[int] = None,
                 bond_feature_dims: Optional[Sequence[int]] = None, norm: str = "batch",
                 mlp_layers: int = 2, eps: float = 1e-7, compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr, self.eps = aggr, eps
        self.compute_dtype = _DTYPES[compute_dtype]
        self.grad_w = learn_t and aggr in ("softmax", "softmax_sum")
        chans = [in_dim] + [in_dim * 2] * (mlp_layers - 1) + [emb_dim]
        self.mlp = MLP(chans, norm=norm, last_lin=True, generator=generator)
        _scalar(self, "t", t, self.grad_w)
        _scalar(self, "p", p, learn_p and aggr in ("power", "power_sum"))
        _scalar(self, "y", y, learn_y and aggr in ("softmax_sum", "power_sum"))
        self.msg_norm = MsgNorm(learn_msg_scale) if msg_norm else None
        self.edge_encoder = None
        if encode_edge and bond_encoder:
            if bond_feature_dims is None:
                raise ValueError("the bond encoder needs bond_feature_dims")
            self.edge_encoder = MultiEmbedding(bond_feature_dims, in_dim,
                                               "bond_embedding_list", generator)
        elif encode_edge:
            self.edge_encoder = Linear(edge_feat_dim, in_dim, generator=generator)

    def _edge_embeddings(self, g: Graph, edge_attr, edge_attr_csc, edge_emb, edge_emb_csc):
        """(edge_emb, edge_emb_csc) in the JAX package's order of precedence
        (`convs/sparse.py:139-152`): given embeddings are used as they are;
        otherwise the raw features (``edge_attr``, else the graph's) are
        encoded here, each edge order separately, or used as they are when
        the conv has no encoder."""
        if edge_emb is not None:
            return edge_emb, edge_emb_csc
        ea = edge_attr if edge_attr is not None else g.edge_attr
        # the sender-ordered twin: explicit edge_attr needs an explicit copy
        ea_csc = edge_attr_csc if edge_attr is not None else g.edge_attr_csc
        if self.edge_encoder is not None:
            if ea is None:
                return None, edge_emb_csc
            if edge_emb_csc is None and ea_csc is not None:
                edge_emb_csc = self.edge_encoder(ea_csc)
            return self.edge_encoder(ea), edge_emb_csc
        return ea, ea_csc if edge_emb_csc is None else edge_emb_csc

    def forward(self, x: torch.Tensor, g: Graph, edge_attr: Optional[torch.Tensor] = None,
                edge_attr_csc: Optional[torch.Tensor] = None,
                edge_emb: Optional[torch.Tensor] = None,
                edge_emb_csc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``edge_attr``: raw edge features, encoded here with ``encode_edge``;
        ``edge_emb``: embeddings used as they are; the ``*_csc`` twins are the
        same in sender order, which the fused route's backward (K4) needs."""
        edge_emb, edge_emb_csc = self._edge_embeddings(g, edge_attr, edge_attr_csc,
                                                       edge_emb, edge_emb_csc)
        n = x.shape[0]
        cd = self.compute_dtype
        xc = x.to(cd)
        if edge_emb is not None and edge_emb.shape[-1] != x.shape[1]:
            raise ValueError(f"edge embeddings of width {edge_emb.shape[-1]} do not match "
                             f"{x.shape[1]} node channels (give the conv an edge encoder)")
        band = edge_emb is None and band_ok(g, self.aggr)
        fused = self.aggr in SOFTMAX_AGGRS and (
            edge_emb is None or (edge_emb_csc is not None
                                 and edge_emb.shape == (g.num_edges_padded, x.shape[1])))
        t = self.t if self.grad_w else self.t.detach()
        if band and self.aggr in BAND_SOFTMAX_AGGRS:
            # gather-free: num/den are one band product of the packed node
            # table, the backward one product over the transpose band
            m = band_softmax_agg_auto(xc, g.band, t, self.eps, self.grad_w)
            if self.aggr == "softmax_sum":
                deg = segment_degree(g.receivers, n, g.edge_mask)
                m = torch.pow(deg, torch.sigmoid(self.y))[:, None].to(m.dtype) * m
        elif band:
            # the sum family, node-factored: the message relu(x) + ε is a
            # node table (`torch_message.py:57-85` semantics)
            msg = torch.relu(x.float()) + self.eps
            deg = segment_degree(g.receivers, n, g.edge_mask)
            mean_div = torch.clamp_min(deg, 1.0)[:, None]
            if self.aggr in ("power", "power_sum"):
                lo, hi = 1e-7, 1e1  # the reference's clamps
                mp = torch.pow(torch.clamp(msg, lo, hi), self.p)
                s = band_sum_auto(mp.to(cd), g.band).float()
                m = torch.pow(torch.clamp(s / mean_div, lo, hi), 1.0 / self.p)
                if self.aggr == "power_sum":
                    m = torch.pow(deg, torch.sigmoid(self.y))[:, None] * m
            else:  # add / sum / mean
                s = band_sum_auto(msg.to(cd), g.band).float()
                m = s / mean_div if self.aggr == "mean" else s
            m = m.to(cd)
        elif fused:
            # the edge-embedding cotangent flows through the sender-ordered
            # copy only (the same values): `ee` enters detached
            ee = ee_csc = None
            if edge_emb is not None:
                ee = edge_emb.detach().to(cd).contiguous()
                ee_csc = edge_emb_csc.to(cd).contiguous()
            m = fused_softmax_gather_agg_auto(
                xc.contiguous(), g.senders, g.row_ptr, g.csc_receivers, g.csc_col_ptr, t,
                ee=ee, ee_csc=ee_csc, eps=self.eps, grad_weights=self.grad_w)
            if self.aggr == "softmax_sum":
                deg = segment_degree(g.receivers, n, g.edge_mask)
                m = torch.pow(deg, torch.sigmoid(self.y))[:, None].to(m.dtype) * m
        else:
            # the gather's backward is K1's gathered form over the CSC ranges,
            # and the sum family's aggregation K1 over the CSR ranges
            msg = gather_src_auto(xc, g)
            if edge_emb is not None:
                msg = msg + edge_emb.to(cd)
            msg = torch.relu(msg) + torch.tensor(self.eps, dtype=cd)
            m = generalized_aggregate(
                msg, g.receivers, n, aggr=self.aggr, t=self.t, p=self.p, y=self.y,
                learn_t=self.grad_w, mask=g.edge_mask, row_ptr=g.row_ptr)
        m = m.to(x.dtype)
        if self.msg_norm is not None:
            m = self.msg_norm(x, m)
        return self.mlp(x + m, g.node_mask,
                        cd if cd == torch.bfloat16 else None)


class _PygGAT(nn.Module):
    """The parameters of PyG 1.x's `GATConv` under its names: weight [in,
    H·D], att [1, H, 2D] (a_l for the receiver, a_r for the sender), bias
    [H·D]; glorot-uniform weight and att, zero bias."""

    def __init__(self, in_dim: int, out_dim: int, heads: int, bias: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        hd = heads * out_dim
        self.weight = nn.Parameter(torch.empty(in_dim, hd))
        self.att = nn.Parameter(torch.empty(1, heads, 2 * out_dim))
        self.bias = nn.Parameter(torch.zeros(hd)) if bias else None
        with torch.no_grad():
            for t, bound in ((self.weight, (6.0 / (in_dim + hd)) ** 0.5),
                             (self.att, (6.0 / (2 * out_dim + 1)) ** 0.5)):
                t.uniform_(-bound, bound, generator=generator)


class GATConv(nn.Module):
    """PyG-1.x GAT conv with activation and norm (reference
    `torch_vertex.py:117-133`): heads concatenated, then act, then norm.
    State-dict names are the reference's: `gconv.weight`, `gconv.att`,
    `gconv.bias`, and the norm at `unlinear.<i>`.

    ``self_loops`` True (PyG's default) softmaxes over the neighbours and
    exactly one self term, explicit self edges excluded; False over the edge
    list as it is (the reversible `GATBlock`), where a receiver with no edge
    gets 0. ``act`` "relu", "leakyrelu", "prelu" (one learned slope at
    `unlinear.0.weight`, initialised to 0.2) or None."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 8, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True, neg_slope: float = 0.2,
                 self_loops: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.neg_slope, self.self_loops = neg_slope, self_loops
        self.gconv = _PygGAT(in_dim, out_dim, heads, bias, generator)
        a = act_layer(act)
        layers = [] if a is None else [a]
        nrm = make_norm(norm, heads * out_dim)
        if nrm is not None:
            layers.append(nrm)
        self.unlinear = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        n = x.shape[0]
        h, d = self.heads, self.out_dim
        ns = self.neg_slope
        xt = (x @ self.gconv.weight).reshape(n, h, d)
        att = self.gconv.att[0]
        s_dst = (xt * att[:, :d]).sum(-1)   # the receiver's half
        s_src = (xt * att[:, d:]).sum(-1)   # the sender's half
        self_score = torch.nn.functional.leaky_relu(s_dst + s_src, ns)
        if band_gat_dense_ok(g):
            if self.self_loops:
                c_self = segment_degree(g.receivers, n, g.edge_mask & (g.senders == g.receivers))
                num, den = band_gat_dense_agg(xt, s_src, s_dst, g.band, ns,
                                              self_score=self_score, self_feat=xt,
                                              self_count=c_self)
            else:
                num, den = band_gat_dense_agg(xt, s_src, s_dst, g.band, ns)
            out = (num / torch.clamp_min(den, 1e-16)[..., None]).to(x.dtype)
        else:
            out = self._segment(xt, s_src, s_dst, self_score, g)
        out = out.reshape(n, h * d)
        if self.gconv.bias is not None:
            out = out + self.gconv.bias
        for layer in self.unlinear:
            out = layer(out) if isinstance(layer, (nn.ReLU, nn.LeakyReLU, PReLU)) else \
                layer(out, g.node_mask)
        return out

    def _segment(self, xt, s_src, s_dst, self_score, g: Graph):
        """The per-edge route: softmax over the neighbours (and the self term)
        with their combined maximum as the stabilizer, no gradient through
        it (`convs/sparse.py:432-455`)."""
        n, h, d = xt.shape
        emask = g.edge_mask & (g.senders != g.receivers) if self.self_loops else g.edge_mask
        recv = torch.clamp(g.receivers.long(), max=n - 1)
        send = torch.clamp(g.senders.long(), max=n - 1)
        e_score = torch.nn.functional.leaky_relu(s_dst[recv] + s_src[send], self.neg_slope)
        neg_inf = float("-inf")
        mx = torch.full((n, h), neg_inf, device=xt.device).scatter_reduce(
            0, recv[:, None].expand(-1, h), torch.where(emask[:, None], e_score, neg_inf),
            "amax")
        if self.self_loops:
            mx = torch.maximum(mx, self_score)
        mx = torch.where(torch.isfinite(mx), mx, 0.0).detach()
        e_exp = torch.where(emask[:, None], torch.exp(e_score - mx[recv]), 0.0)
        denom = segment_sum(e_exp, g.receivers, n)
        if self.self_loops:
            self_exp = torch.exp(self_score - mx)
            denom = denom + self_exp
        alpha = e_exp / torch.clamp_min(denom[recv], 1e-16)
        msg = gather_src_auto(xt.reshape(n, h * d), g).reshape(-1, h, d) * alpha[..., None]
        out = segment_sum(torch.where(emask[:, None, None], msg, 0.0), g.receivers, n)
        if self.self_loops:
            out = out + xt * (self_exp / torch.clamp_min(denom, 1e-16))[..., None]
        return out
