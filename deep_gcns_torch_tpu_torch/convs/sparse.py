"""The sparse conv zoo: GENConv, MsgNorm, the PyG-1.x GATConv, MRConv,
EdgeConv, (R)SAGEConv, SemiGCNConv, GINConv, `graph_conv` and the res/dense
blocks (counterpart of `deep_gcns_torch_tpu/convs/sparse.py:41-764`).

Routing of GENConv's aggregation, in the JAX package's order
(`convs/sparse.py:167-236`):

* without edge embeddings and with a band attached that passes `band_ok`
  (`ops/band.py`), the softmax family goes to `band_softmax_agg_auto` (K3,
  K1 for the leftover, dense hub products) and add, sum, mean, power and
  power_sum to `band_sum_auto` on a node table; max and min go to
  `band_extreme` (the masked window reduce) when `band_extreme_route`
  holds (on the CPU only: on the card the gather path is faster);
* otherwise, when the graph carries its CSR and CSC auxiliaries
  (`fused_gather_ok`), the softmax family goes to
  `fused_softmax_gather_agg`, which launches K2 in the forward and K4's
  gather form in the backward, or, with edge embeddings in both edge orders,
  K2 with `ee` and K4 with `ee` (each receiver's softmax shifted by its own
  maximum);
* everything else gathers the messages relu(x_j [+ e]) + ε (`gather_src_auto`:
  K1's gathered form in the backward when the graph has its CSC) and runs
  `generalized_aggregate`, whose kernel routes given ``row_ptr`` are K1 for
  the sum family and K2's message form for the softmax family.

GATConv scores s_ij = leaky_relu(a_l·x_i + a_r·x_j) per head, a
destination score, so on a band that passes `band_gat_dense_ok` it takes the
dense route (`band_gat_dense_agg`: K7 forward, K8 and K9 backward), and
otherwise the per-edge segment softmax with a combined per-receiver maximum.

The other convs gather with `ops/gather.py` (K1 in the backward) and sum
with `segment_sum(..., row_ptr=)` (K1 for rows of 32 or more); SemiGCN, GIN
and SAGE sum through `band_sum_auto` (K3) on a band that passes
`band_sum_ok`, MRConv's max/min through `band_extreme` where
`band_extreme_route` holds (the CPU). Parameter names are
the reference's `state_dict` names (`nn.0.weight`, `gconv.weight`,
`unlinear.<i>`, ...), so its checkpoints and goldens load as they are.
`DynConv` and the dynamic blocks build a flat dilated kNN graph per forward
(`ops.knn.dilated_knn_graph_flat`) with no CSR or CSC auxiliaries, so, as
in the JAX package, whose `_pallas_ok` refuses a graph without `row_ptr`,
they launch no kernel.

On a CPU tensor every kernel runs its plain version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..graph import Graph
from ..nn.core import MLP, Linear, MultiEmbedding, PReLU, act_layer, make_norm
from ..ops.band import (BAND_SOFTMAX_AGGRS, band_extreme, band_extreme_route, band_gat_dense_agg,
                        band_gat_dense_ok, band_ok, band_softmax_agg_auto, band_sum_auto,
                        band_sum_ok)
from ..ops.gather import gather_dst_auto, gather_src_auto
from ..ops.knn import dilated_knn_graph_flat
from ..ops.segment import (fused_gather_ok, generalized_aggregate, scatter, segment_degree,
                           segment_sum)
from ..ops.spmm_cuda import fused_softmax_gather_agg_auto
from ..utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A conv's ``compute_dtype`` ("float32", "bfloat16" or None)."""
    return None if name is None else _DTYPES[name]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with the sentinel indices clamped to the last row (their
    rows are masked downstream)."""
    return x.index_select(0, torch.clamp(idx.long(), max=x.shape[0] - 1))


def _no_self_mask(g: Graph) -> torch.Tensor:
    return g.edge_mask & (g.senders != g.receivers)


def _post(out: torch.Tensor, layers: nn.ModuleList, mask: torch.Tensor) -> torch.Tensor:
    """The reference's `unlinear` after a PyG conv: the activation, then the
    norm (which reads the node mask)."""
    for layer in layers:
        out = layer(out) if isinstance(layer, (nn.ReLU, nn.LeakyReLU, PReLU)) else \
            layer(out, mask)
    return out


def _unlinear(act: Optional[str], norm: Optional[str], dim: int) -> nn.ModuleList:
    a, nrm = act_layer(act), make_norm(norm, dim)
    return nn.ModuleList([m for m in (a, nrm) if m is not None])


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
    `convs/sparse.py:103-109`). Spans (`utils/profiling.span`): ``gen.aggregate``
    around the aggregation, ``gen.mlp`` around the update MLP; the fused
    route's backward records ``gen.aggregate_bwd``."""

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
        cd = self.compute_dtype
        with span("gen.aggregate"):
            m = self._aggregate(x, g, edge_emb, edge_emb_csc).to(x.dtype)
        if self.msg_norm is not None:
            m = self.msg_norm(x, m)
        with span("gen.mlp"):
            return self.mlp(x + m, g.node_mask, cd if cd == torch.bfloat16 else None)

    def _aggregate(self, x: torch.Tensor, g: Graph, edge_emb: Optional[torch.Tensor],
                   edge_emb_csc: Optional[torch.Tensor]) -> torch.Tensor:
        """The aggregation of the messages relu(x_j [+ e]) + ε into each
        receiver, by the first route that the graph allows (the module's
        docstring), in the compute dtype."""
        n = x.shape[0]
        cd = self.compute_dtype
        xc = x.to(cd)
        if edge_emb is not None and edge_emb.shape[-1] != x.shape[1]:
            raise ValueError(f"edge embeddings of width {edge_emb.shape[-1]} do not match "
                             f"{x.shape[1]} node channels (give the conv an edge encoder)")
        band = edge_emb is None and band_ok(g, self.aggr)
        band_ext = (edge_emb is None and self.aggr in ("max", "min")
                    and band_extreme_route(g, x))
        # the fused pair reads the CSR and CSC auxiliaries: without them the
        # unfused branch runs, as in the JAX package
        fused = fused_gather_ok(g, self.aggr) and (
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
        elif band_ext:
            # max/min of the node table relu(x) + ε over each receiver's
            # senders: the masked window reduce, a tie-splitting backward
            msg = (torch.relu(x.float()) + self.eps).to(cd)
            m = band_extreme(msg, g.band, g.senders, g.receivers, g.edge_mask, self.aggr)
        elif fused:
            # the edge-embedding cotangent flows through the sender-ordered
            # copy only (the same values): `ee` enters detached
            ee = ee_csc = None
            if edge_emb is not None:
                ee = edge_emb.detach().to(cd).contiguous()
                ee_csc = edge_emb_csc.to(cd).contiguous()
            m = fused_softmax_gather_agg_auto(
                xc.contiguous(), g.senders, g.row_ptr, g.row_order, g.csc_receivers,
                g.csc_col_ptr, g.csc_order, t,
                ee=ee, ee_csc=ee_csc, eps=self.eps, grad_weights=self.grad_w,
                split_rows=g.split_rows)
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
        return m


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
        self.unlinear = _unlinear(act, norm, heads * out_dim)

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
        return _post(out, self.unlinear, g.node_mask)

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
        out = segment_sum(torch.where(emask[:, None, None], msg, 0.0), g.receivers, n,
                          row_ptr=g.row_ptr)
        if self.self_loops:
            out = out + xt * (self_exp / torch.clamp_min(denom, 1e-16))[..., None]
        return out


class MRConv(nn.Module):
    """Max-relative conv (reference `torch_vertex.py:91-103`): agg =
    extreme_j (x_j − x_i), then nn([x ‖ agg]), nn = MLP([2·in, out]) under
    the reference's name `nn`. ``compute_dtype`` "bfloat16" rounds x once
    before the edge-wide gathers and runs the MLP's product in bf16 with
    float32 accumulation. Where `band_extreme_route` holds the
    extreme is the window reduce of x itself: extreme_j (x_j − x_i) =
    (extreme_j x_j) − x_i for a receiver with an edge, 0 for one without."""

    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True, aggr: str = "max",
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr, self.compute_dtype = aggr, _dtype(compute_dtype)
        self.nn = MLP([in_dim * 2, out_dim], norm=norm, bias=bias, act=act,
                      generator=generator)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        cd = self.compute_dtype
        xe = x if cd is None else x.to(cd)  # rounded before the E-wide gathers
        n = x.shape[0]
        if self.aggr in ("max", "min") and band_extreme_route(g, x):
            ext = band_extreme(xe, g.band, g.senders, g.receivers, g.edge_mask, self.aggr)
            deg = (g.row_ptr[1:] - g.row_ptr[:-1]) if g.row_ptr is not None else \
                segment_degree(g.receivers, n, g.edge_mask)
            agg = torch.where((deg > 0)[:, None], ext - xe, torch.zeros((), dtype=xe.dtype,
                                                                        device=xe.device))
        else:
            rel = gather_src_auto(xe, g) - gather_dst_auto(xe, g)
            agg = scatter(self.aggr, rel, g.receivers, n, mask=g.edge_mask, row_ptr=g.row_ptr)
        return self.nn(torch.cat([xe, agg], 1), g.node_mask, cd)


class EdgeConv(nn.Module):
    """PyG EdgeConv (reference `torch_vertex.py:106-114`): msg_ij =
    nn([x_i ‖ x_j − x_i]) per edge, its BatchNorm over the valid edges
    (`edge_mask`), then the max (or ``aggr``) over each receiver's edges.
    ``compute_dtype`` "bfloat16" keeps the edge-wide tensors in bf16 and
    returns float32."""

    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True, aggr: str = "max",
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr, self.compute_dtype = aggr, _dtype(compute_dtype)
        self.nn = MLP([in_dim * 2, out_dim], norm=norm, bias=bias, act=act,
                      generator=generator)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        cd = self.compute_dtype
        xe = x if cd is None else x.to(cd)
        x_i = gather_dst_auto(xe, g)
        x_j = gather_src_auto(xe, g)
        msg = self.nn(torch.cat([x_i, x_j - x_i], 1), g.edge_mask, cd)
        if cd is not None:
            msg = msg.to(cd)  # the edge-wide aggregate reads bf16
        out = scatter(self.aggr, msg, g.receivers, x.shape[0], mask=g.edge_mask,
                      row_ptr=g.row_ptr)
        return out.float() if cd is not None else out


class RSAGEConv(nn.Module):
    """The reference's (R)SAGEConv (`torch_vertex.py:136-205`): one self
    loop, message (x_j [− x_i]) @ W, the mean over the neighbours (self
    edges excluded) and the self term, update nn([x ‖ agg]) + b, nn =
    MLP([out + in, out]); with a norm the output is L2-normalised. Names:
    `weight` [in, out], `bias`, `nn.*`. On a band that passes `band_sum_ok`
    the neighbour sum is one band product (K3) with the self edges' share
    taken out in closed form."""

    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True, relative: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim, self.relative = out_dim, relative
        self.normalize = norm is not None and str(norm).lower() != "none"
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim))
        with torch.no_grad():
            self.weight.uniform_(-in_dim ** -0.5, in_dim ** -0.5, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None
        self.nn = MLP([out_dim + in_dim, out_dim], norm=norm, bias=bias, act=act,
                      generator=generator)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        n = x.shape[0]
        emask = _no_self_mask(g)
        if band_sum_ok(g):
            # relative messages vanish on self edges; a plain one adds xt_i
            # per self edge, taken out before the one self term is added
            if self.relative:
                deg_all = segment_degree(g.receivers, n, g.edge_mask)
                s = (band_sum_auto(x, g.band) - deg_all[:, None] * x) @ self.weight
            else:
                xt = x @ self.weight
                c_self = segment_degree(g.receivers, n, g.edge_mask & (g.senders == g.receivers))
                s = (band_sum_auto(xt, g.band) - c_self[:, None] * xt) + xt
        else:
            if self.relative:
                msg = (gather_src_auto(x, g) - gather_dst_auto(x, g)) @ self.weight
                self_msg = 0.0
            else:
                msg = gather_src_auto(x, g) @ self.weight
                self_msg = x @ self.weight
            s = segment_sum(msg, g.receivers, n, emask, g.row_ptr) + self_msg
        cnt = segment_degree(g.receivers, n, emask) + 1.0
        out = self.nn(torch.cat([x, s / cnt[:, None]], 1), g.node_mask)
        if self.bias is not None:
            out = out + self.bias
        if self.normalize:
            out = out / torch.clamp_min(torch.linalg.norm(out, dim=-1, keepdim=True), 1e-12)
        return out


class GCNConv(nn.Module):
    """PyG 1.x's `GCNConv` under its names, `weight` [in, out] (glorot) and
    `bias` (zeros): Kipf's symmetric normalisation with the remaining-self-
    loops semantics (a node without a self edge gets one; the degree counts
    the neighbours and that loop), the self term analytic. On a band that
    passes `band_sum_ok` the normalised sum is dinv ⊙ (A @ (dinv ⊙ xW)), one
    band product (K3)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim))
        with torch.no_grad():
            bound = (6.0 / (in_dim + out_dim)) ** 0.5
            self.weight.uniform_(-bound, bound, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        n = x.shape[0]
        xt = x @ self.weight
        emask = g.edge_mask
        has_self = torch.clamp_max(
            segment_degree(g.receivers, n, emask & (g.senders == g.receivers)), 1.0)
        deg = segment_degree(g.receivers, n, emask) + (1.0 - has_self)
        dinv = torch.rsqrt(torch.clamp_min(deg, 1.0))
        if band_sum_ok(g):
            out = dinv[:, None] * band_sum_auto(dinv[:, None] * xt, g.band)
        else:
            coef = gather(dinv, g.receivers) * gather(dinv, g.senders)
            msg = gather_src_auto(xt, g) * coef[:, None]
            out = segment_sum(msg, g.receivers, n, emask, g.row_ptr)
        out = out + xt * ((1.0 - has_self) * dinv * dinv)[:, None]
        return out if self.bias is None else out + self.bias


class SemiGCNConv(nn.Module):
    """Kipf's GCN then act and norm (reference `torch_vertex.py:208-225`):
    `gconv.weight`, `gconv.bias`, the act and norm at `unlinear.<i>`."""

    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gconv = GCNConv(in_dim, out_dim, bias, generator)
        self.unlinear = _unlinear(act, norm, out_dim)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        return _post(self.gconv(x, g), self.unlinear, g.node_mask)


class GINConv(nn.Module):
    """GIN (reference `torch_vertex.py:228-236`): nn((1 + ε)·x + Σ_j x_j),
    nn = MLP([in, out]) at `nn.*`; the neighbour sum is one band product
    (K3) on a band that passes `band_sum_ok`."""

    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True, eps: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = eps
        self.nn = MLP([in_dim, out_dim], norm=norm, bias=bias, act=act, generator=generator)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        if band_sum_ok(g):
            agg = band_sum_auto(x, g.band)
        else:
            agg = segment_sum(gather_src_auto(x, g), g.receivers, x.shape[0], g.edge_mask,
                              g.row_ptr)
        return self.nn((1.0 + self.eps) * x + agg, g.node_mask)


def graph_conv(in_dim: int, out_dim: int, conv: str = "edge", act: Optional[str] = "relu",
               norm: Optional[str] = None, bias: bool = True, heads: int = 8,
               compute_dtype: Optional[str] = None,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """The reference's `GraphConv` dispatch (`torch_vertex.py:239-264`): edge,
    mr, gat (``heads`` heads of out_dim // heads), gcn, gin, sage, rsage.
    ``compute_dtype`` reaches the convs that take it (edge, mr)."""
    c = conv.lower()
    kw = dict(act=act, norm=norm, bias=bias, generator=generator)
    if c == "edge":
        return EdgeConv(in_dim, out_dim, compute_dtype=compute_dtype, **kw)
    if c == "mr":
        return MRConv(in_dim, out_dim, compute_dtype=compute_dtype, **kw)
    if c == "gat":
        return GATConv(in_dim, out_dim // heads, heads=heads, **kw)
    if c == "gcn":
        return SemiGCNConv(in_dim, out_dim, **kw)
    if c == "gin":
        return GINConv(in_dim, out_dim, **kw)
    if c in ("sage", "rsage"):
        return RSAGEConv(in_dim, out_dim, relative=c == "rsage", **kw)
    raise NotImplementedError(f"conv {conv} is not implemented")


class GraphConv(nn.Module):
    """The reference's `GraphConv` wrapper: the conv at `gconv`, so that a
    model's names are the reference's (`head.gconv.nn.0.weight`)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.gconv = graph_conv(*args, **kwargs)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        return self.gconv(x, g)


class _Block(nn.Module):
    """plain / res / dense wrapper of a `GraphConv` at `body`
    (`torch_vertex.py:284-352`): res y + res_scale·x, dense [x ‖ y]."""

    def __init__(self, body: nn.Module, kind: str, res_scale: float = 1.0):
        super().__init__()
        self.body, self.kind, self.res_scale = body, kind, res_scale

    def forward(self, x: torch.Tensor, g: Optional[Graph] = None, *args) -> torch.Tensor:
        y = self.body(x, g, *args)
        if self.kind == "res":
            return y + x * self.res_scale
        if self.kind == "dense":
            return torch.cat([x, y], 1)
        return y


def ResGraphBlock(channels: int, conv: str = "edge", act: Optional[str] = "relu",
                  norm: Optional[str] = None, bias: bool = True, heads: int = 8,
                  res_scale: float = 1.0, compute_dtype: Optional[str] = None,
                  generator: Optional[torch.Generator] = None) -> _Block:
    return _Block(GraphConv(channels, channels, conv, act, norm, bias, heads, compute_dtype,
                            generator), "res", res_scale)


def DenseGraphBlock(in_channels: int, out_channels: int, conv: str = "edge",
                    act: Optional[str] = "relu", norm: Optional[str] = None, bias: bool = True,
                    heads: int = 8, compute_dtype: Optional[str] = None,
                    generator: Optional[torch.Generator] = None) -> _Block:
    return _Block(GraphConv(in_channels, out_channels, conv, act, norm, bias, heads,
                            compute_dtype, generator), "dense")


def knn_graph(senders: torch.Tensor, receivers: torch.Tensor, n: int) -> Graph:
    """The Graph of a flat kNN edge list over n nodes: every node and edge
    valid, no CSR or CSC auxiliaries (JAX `convs/sparse.py:718-725`)."""
    dev = senders.device
    return Graph(x=None, senders=senders, receivers=receivers, edge_attr=None,
                 node_mask=torch.ones(n, dtype=torch.bool, device=dev),
                 edge_mask=torch.ones(senders.shape, dtype=torch.bool, device=dev),
                 n_node=n, n_edge=int(senders.shape[0]))


class DynConv(GraphConv):
    """A `GraphConv` on the dilated kNN graph of its input, built per forward
    over equally sized graphs of ``num_points`` nodes stacked flat
    (`torch_vertex.py:267-281`); kNN draws its stochastic choices from the
    forward's generator in training mode."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 9, dilation: int = 1,
                 conv: str = "edge", act: Optional[str] = "relu", norm: Optional[str] = None,
                 bias: bool = True, heads: int = 8, stochastic: bool = False,
                 epsilon: float = 0.0, num_points: int = 1024, knn_method: str = "exact",
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, conv, act, norm, bias, heads, compute_dtype, generator)
        self.k, self.dilation, self.num_points = kernel_size, dilation, num_points
        self.stochastic, self.epsilon, self.knn_method = stochastic, epsilon, knn_method

    def forward(self, x: torch.Tensor, g: Optional[Graph] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if g is None:
            senders, receivers = dilated_knn_graph_flat(
                x, self.k, self.dilation, num_nodes_per_graph=self.num_points,
                stochastic=self.stochastic, epsilon=self.epsilon, train=self.training,
                generator=generator, method=self.knn_method)
            g = knn_graph(senders, receivers, x.shape[0])
        return self.gconv(x, g)


def PlainDynBlock(channels: int, kernel_size: int = 9, dilation: int = 1, conv: str = "edge",
                  act: Optional[str] = "relu", norm: Optional[str] = None, bias: bool = True,
                  num_points: int = 1024, **kw) -> _Block:
    return _Block(DynConv(channels, channels, kernel_size, dilation, conv, act, norm, bias,
                          num_points=num_points, **kw), "plain")


def ResDynBlock(channels: int, kernel_size: int = 9, dilation: int = 1, conv: str = "edge",
                act: Optional[str] = "relu", norm: Optional[str] = None, bias: bool = True,
                res_scale: float = 1.0, num_points: int = 1024, **kw) -> _Block:
    return _Block(DynConv(channels, channels, kernel_size, dilation, conv, act, norm, bias,
                          num_points=num_points, **kw), "res", res_scale)


def DenseDynBlock(in_channels: int, out_channels: int = 64, kernel_size: int = 9,
                  dilation: int = 1, conv: str = "edge", act: Optional[str] = "relu",
                  norm: Optional[str] = None, bias: bool = True, num_points: int = 1024,
                  **kw) -> _Block:
    return _Block(DynConv(in_channels, out_channels, kernel_size, dilation, conv, act, norm,
                          bias, num_points=num_points, **kw), "dense")
