"""DeeperGCN backbone: GENConv with res+/res/plain blocks (counterpart of
`deep_gcns_torch_tpu/models/deeper_gcn.py:31-337`).

The JAX package runs the layer stack under `lax.scan` over stacked per-layer
parameters; here it is a Python loop over `nn.ModuleList`s whose names follow
the reference `state_dict` (`node_features_encoder`, `node_one_hot_encoder`,
`edge_encoder`, `gcns.{i}.mlp.0`, `gcns.{i}.edge_encoder`, `gcns.{i}.t` when
learned, `norms.{i}`, `node_pred_linear`; the ogbg models' `atom_encoder`,
`bond_encoder`, `virtualnode_embedding`, `mlp_virtualnode_list.{i}` and
`graph_pred_linear`, `examples/ogb/ogbg_mol/model.py`).

Block semantics (reference `examples/ogb/ogbn_arxiv/model.py:84-136`):
  res+ : h ← gcn_l( drop( relu( norm_{l-1}(h) ) ) ) + h   (pre-activation)
  res  : h ← relu( norm_l( gcn_l(h) ) ) + h, then dropout
  plain: h ← drop( relu( norm_l( gcn_l(h) ) ) )

Node encoders: "linear" (Linear(in_channels, C)) or "atom" (the AtomEncoder,
a sum of embeddings of the 9 integer atom features). Edge features
(`deeper_gcn.py:53-59, 101-131, 186-196`): ``edge_mode`` "per_layer" gives
every GENConv its own Linear edge encoder and "bond" its own BondEncoder;
"one_time" (Linear) and "one_time_bond" (BondEncoder) encode once at the
model level and feed the same embeddings to every layer. Either way
`g.edge_attr` and `g.edge_attr_csc` are encoded separately, never permuted
on the card, so that the fused route's backward (K4) gets its sender-ordered
copy; the embedding tables get their gradient from that copy alone. The
proteins one-hot encoder (``use_one_hot_encoding``) concatenates the node
features with Linear(species one-hot).

Graph level (ogbg): ``add_virtual_node`` (res+ only, `deeper_gcn.py:156-159,
198-204, 239-275`) adds one zero-initialised embedding per graph to every
node, and before each layer after the first feeds the graph's sum-pooled
nodes plus its embedding through that layer's MLP((C,)·3) and dropout back
into the nodes; ``graph_pooling`` (mean, sum or max over `g.node_graph`
under `g.node_mask`, `:331-333`) pools the nodes before the prediction head.

Spans (`utils/profiling.span`): ``deeper.norm`` around each res+ prologue
(norm → relu → dropout) and the final norm, relu and dropout; GENConv's own
``gen.aggregate`` and ``gen.mlp`` sit inside each conv.

On the card each res+ prologue, and the final norm → relu → dropout, is one
autograd Function on K11 (`ops/norm_act.py`, `csrc/batch_norm_act.cu`) when
the norm is a `BatchNorm` with its own moments and the residual stream is
float32: in training the batch's masked statistics, the running statistics'
update (none in a checkpointed recompute) and the dropout multiply by the
keep mask, drawn first by `nn.core.dropout`'s own call, so the stream of
draws is unchanged; in evaluation the running statistics, one launch. The
eager chain runs everywhere else: on the CPU (bit for bit what it was), for
LayerNorm and the `res`/`plain` epilogues, and on the card for a bf16
residual carry or cross-rank moments (`sync_batch_norm`), which the route
could serve in principle and which count as misses of ``deeper.norm_act``
in `ops.route_misses`.

Memory knobs (`deeper_gcn.py:62-76, 235, 271, 309, 325` there), both on
`nn.core.checkpoint_replay` (`torch.utils.checkpoint`, non-reentrant; the
recompute replays the dropout generator and leaves BatchNorm's running
statistics alone): ``remat`` recomputes each layer body after the first in
the backward; ``checkpoint_prologue`` recomputes, at train time, each
norm → relu → dropout prologue (res+) or epilogue (res, plain) instead of
keeping its masks. The port's default for ``checkpoint_prologue`` is False
(JAX's is True): the math is the same, and the port's chip numbers were
taken without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..convs.sparse import GENConv
from ..graph import Graph
from ..nn.core import (MLP, BatchNorm, Embedding, Linear, MultiEmbedding, checkpoint_replay,
                       dropout, make_norm, running_stats_frozen)
from ..ops.norm_act import batch_norm_act, batch_norm_act_eval
from ..ops.route_misses import miss
from ..ops.segment import scatter, segment_sum
from ..utils.profiling import span


@dataclass(frozen=True)
class DeeperGCNConfig:
    in_channels: int
    hidden_channels: int
    num_tasks: int
    num_layers: int = 28
    block: str = "res+"
    aggr: str = "softmax"
    t: float = 1.0
    learn_t: bool = False
    p: float = 1.0
    learn_p: bool = False
    y: float = 0.0
    learn_y: bool = False
    msg_norm: bool = False
    learn_msg_scale: bool = False
    norm: str = "batch"
    mlp_layers: int = 1
    dropout: float = 0.0
    node_encoder: str = "linear"
    atom_feature_dims: Optional[Tuple[int, ...]] = None
    edge_mode: str = "none"
    edge_feat_dim: int = 0
    bond_feature_dims: Optional[Tuple[int, ...]] = None
    graph_pooling: str = ""
    remat: bool = False
    add_virtual_node: bool = False
    checkpoint_prologue: bool = False
    final_relu: bool = True
    final_dropout: bool = True
    use_one_hot_encoding: bool = False
    node_feat_dim: int = 0
    compute_dtype: str = "float32"
    residual_dtype: str = "float32"


EDGE_MODES = ("none", "per_layer", "one_time", "bond", "one_time_bond")
NODE_ENCODERS = ("linear", "atom")
POOLINGS = ("", "mean", "sum", "add", "max", "min")


def _k11_takes(norm: nn.Module, h: torch.Tensor) -> bool:
    """Whether K11 serves ``norm`` → ReLU → dropout of ``h``: a `BatchNorm`
    with its own moments on a float32 CUDA tensor. On the card a fallback
    the route could serve counts as a miss of ``deeper.norm_act``."""
    if not (h.is_cuda and isinstance(norm, BatchNorm)):
        return False
    if norm.cross_rank:
        return miss("deeper.norm_act", "cross-rank moments", warn=True)
    if h.dtype != torch.float32:
        return miss("deeper.norm_act", f"{str(h.dtype).replace('torch.', '')} carry", warn=True)
    return True


def norm_relu_dropout(norm: nn.Module, h: torch.Tensor, mask: torch.Tensor, rate: float,
                      train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """dropout(relu(norm(h, mask))): one K11 Function where `_k11_takes`,
    else the eager chain. The keep mask is `nn.core.dropout`'s draw, taken
    before the kernel; the running statistics move as `BatchNorm` moves
    them, and not under `_frozen_running_stats`."""
    if not _k11_takes(norm, h):
        return dropout(torch.relu(norm(h, mask)), rate, train=train, generator=generator)
    if not norm.training:
        y = batch_norm_act_eval(h, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                                norm.eps)
        return dropout(y, rate, train=train, generator=generator)
    keep = None
    if train and rate > 0.0:
        keep = torch.rand(h.shape, device=h.device, generator=generator) >= rate
    running = None
    if not running_stats_frozen():
        running = (norm.running_mean, norm.running_var, norm.momentum)
        norm.num_batches_tracked.add_(1)
    return batch_norm_act(h, mask, norm.weight, norm.bias, keep=keep, rate=rate, eps=norm.eps,
                          running=running)


class DeeperGCN(nn.Module):
    def __init__(self, cfg: DeeperGCNConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.block not in ("res+", "res", "plain"):
            raise NotImplementedError(f"Unknown block Type {cfg.block}")
        for name, allowed in (("edge_mode", EDGE_MODES), ("node_encoder", NODE_ENCODERS),
                              ("graph_pooling", POOLINGS)):
            if getattr(cfg, name) not in allowed:
                raise ValueError(f"DeeperGCNConfig.{name}={getattr(cfg, name)!r} is not one "
                                 f"of {allowed}")
        if cfg.add_virtual_node and cfg.block != "res+":
            raise ValueError("the virtual node is wired for res+ (the reference's config)")
        self.cfg = c = cfg
        C = c.hidden_channels
        if c.use_one_hot_encoding:
            self.node_one_hot_encoder = Linear(c.in_channels, c.in_channels,
                                               generator=generator)
        if c.node_encoder == "atom":
            if c.atom_feature_dims is None:
                raise ValueError("node_encoder='atom' needs atom_feature_dims")
            self.atom_encoder = MultiEmbedding(c.atom_feature_dims, C, "atom_embedding_list",
                                               generator)
        else:
            enc_in = c.node_feat_dim + c.in_channels if c.use_one_hot_encoding \
                else c.in_channels
            self.node_features_encoder = Linear(enc_in, C, generator=generator)
        self.gcns = nn.ModuleList(
            GENConv(C, C, aggr=c.aggr, t=c.t,
                    learn_t=c.learn_t, p=c.p, learn_p=c.learn_p, y=c.y,
                    learn_y=c.learn_y, msg_norm=c.msg_norm,
                    learn_msg_scale=c.learn_msg_scale,
                    encode_edge=c.edge_mode in ("per_layer", "bond"),
                    bond_encoder=c.edge_mode == "bond",
                    edge_feat_dim=c.edge_feat_dim or None,
                    bond_feature_dims=c.bond_feature_dims, norm=c.norm,
                    mlp_layers=c.mlp_layers, compute_dtype=c.compute_dtype,
                    generator=generator)
            for _ in range(c.num_layers))
        self.norms = nn.ModuleList(make_norm(c.norm, C) for _ in range(c.num_layers))
        if c.add_virtual_node:
            self.virtualnode_embedding = Embedding(1, C)
            nn.init.zeros_(self.virtualnode_embedding.weight)
            self.mlp_virtualnode_list = nn.ModuleList(
                MLP((C,) * 3, norm=c.norm, generator=generator)
                for _ in range(c.num_layers - 1))
        pred = Linear(C, c.num_tasks, generator=generator)
        if c.graph_pooling:
            self.graph_pred_linear = pred
        else:
            self.node_pred_linear = pred
        if c.edge_mode == "one_time":
            self.edge_encoder = Linear(c.edge_feat_dim, C, generator=generator)
        elif c.edge_mode == "one_time_bond":
            if c.bond_feature_dims is None:
                raise ValueError("edge_mode='one_time_bond' needs bond_feature_dims")
            self.bond_encoder = MultiEmbedding(c.bond_feature_dims, C, "bond_embedding_list",
                                               generator)

    def _model_edge_embeddings(self, g) -> dict:
        """The model-level edge embeddings ("one_time" / "one_time_bond") as
        GENConv keyword arguments, each edge order encoded separately."""
        ee = {}
        enc = {"one_time": "edge_encoder", "one_time_bond": "bond_encoder"}.get(self.cfg.edge_mode)
        if enc is not None and g.edge_attr is not None:
            encoder = getattr(self, enc)
            ee["edge_emb"] = encoder(g.edge_attr)
            if g.edge_attr_csc is not None:
                ee["edge_emb_csc"] = encoder(g.edge_attr_csc)
        return ee

    def _conv(self, i: int, h: torch.Tensor, g, ee: dict) -> torch.Tensor:
        """Layer i's GENConv on ``h`` (the spatial twin exchanges boundary
        rows here, `parallel/spatial.py`)."""
        return self.gcns[i](h, g, **ee)

    def forward(self, x: torch.Tensor, g: Graph,
                generator: Optional[torch.Generator] = None,
                node_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [N_pad, num_tasks], or [num_graphs, num_tasks] with
        ``graph_pooling``; dropout masks come from ``generator`` in training
        mode. With the one-hot encoder ``x`` is the species one-hot and
        ``node_feats`` the aggregated node features; with the atom encoder
        ``x`` holds the integer atom features."""
        c = self.cfg
        train = self.training
        mask = g.node_mask
        carry = torch.bfloat16 if c.residual_dtype == "bfloat16" else None

        def drop(h):
            return dropout(h, c.dropout, train=train, generator=generator)

        def ckpt(on: bool, fn, *args):
            """``fn(*args)``, recomputed in the backward when ``on``."""
            if on and torch.is_grad_enabled():
                return checkpoint_replay(fn, generator, *args)
            return fn(*args)

        ckpt_pro = train and c.checkpoint_prologue

        if c.use_one_hot_encoding:
            if node_feats is None:
                raise ValueError("use_one_hot_encoding needs node_feats")
            x = torch.cat([node_feats, self.node_one_hot_encoder(x)], 1)
        h = self.atom_encoder(x) if c.node_encoder == "atom" else self.node_features_encoder(x)
        if carry is not None:
            h = h.to(carry)
        ee = self._model_edge_embeddings(g)
        if c.block == "res+":
            vn = node_graph = None
            if c.add_virtual_node:
                if g.node_graph is None:
                    raise ValueError("the virtual node needs g.node_graph")
                # padded nodes carry the sentinel num_graphs: clamp, then mask
                node_graph = torch.clamp(g.node_graph.long(), max=g.num_graphs - 1)
                vn = self.virtualnode_embedding.weight.expand(g.num_graphs, -1)
                h = h + torch.where(mask[:, None], vn.index_select(0, node_graph), 0.0)
            h = self._conv(0, h, g, ee)
            if carry is not None:
                h = h.to(carry)

            def prologue(h, i):
                return norm_relu_dropout(self.norms[i - 1], h, mask, c.dropout, train,
                                         generator)

            def body(h, vn, i):
                with span("deeper.norm"):
                    h2 = ckpt(ckpt_pro, prologue, h, i)
                if vn is not None:
                    pooled = segment_sum(h2, g.node_graph, g.num_graphs, mask)
                    vn = drop(self.mlp_virtualnode_list[i - 1](pooled + vn))
                    h2 = h2 + vn.index_select(0, node_graph) * mask[:, None]
                return h + self._conv(i, h2, g, ee).to(h.dtype), vn

            for i in range(1, c.num_layers):
                h, vn = ckpt(c.remat, body, h, vn, i)
            with span("deeper.norm"):
                rate = c.dropout if c.final_dropout else 0.0
                if c.final_relu:
                    h = norm_relu_dropout(self.norms[c.num_layers - 1], h, mask, rate, train,
                                          generator)
                else:
                    h = dropout(self.norms[c.num_layers - 1](h, mask), rate, train=train,
                                generator=generator)
        else:
            def epilogue(h1, h, i):
                h3 = torch.relu(self.norms[i](h1, mask))
                return drop(h3 + h if c.block == "res" else h3)

            def body(h, i):
                return ckpt(ckpt_pro, epilogue, self._conv(i, h, g, ee), h, i)

            for i in range(c.num_layers):
                h = ckpt(c.remat, body, h, i)
        if c.graph_pooling:
            if g.node_graph is None:
                raise ValueError("graph_pooling needs g.node_graph")
            return self.graph_pred_linear(scatter(c.graph_pooling, h, g.node_graph,
                                                  g.num_graphs, mask))
        return self.node_pred_linear(h)
