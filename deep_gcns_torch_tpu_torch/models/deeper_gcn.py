"""DeeperGCN backbone: GENConv with res+/res/plain blocks (counterpart of
`deep_gcns_torch_tpu/models/deeper_gcn.py:31-337`).

The JAX package runs the layer stack under `lax.scan` over stacked per-layer
parameters; here it is a Python loop over `nn.ModuleList`s whose names follow
the reference `state_dict` (`node_features_encoder`, `node_one_hot_encoder`,
`edge_encoder`, `gcns.{i}.mlp.0`, `gcns.{i}.edge_encoder`, `gcns.{i}.t` when
learned, `norms.{i}`, `node_pred_linear`).

Block semantics (reference `examples/ogb/ogbn_arxiv/model.py:84-136`):
  res+ : h ← gcn_l( drop( relu( norm_{l-1}(h) ) ) ) + h   (pre-activation)
  res  : h ← relu( norm_l( gcn_l(h) ) ) + h, then dropout
  plain: h ← drop( relu( norm_l( gcn_l(h) ) ) )

Edge features (`deeper_gcn.py:53-59, 101-131, 186-196`): ``edge_mode``
"per_layer" gives every GENConv its own edge encoder; "one_time" encodes once
at the model level and feeds the same embeddings to every layer. Either way
`g.edge_attr` and `g.edge_attr_csc` are encoded separately, never permuted on
the card, so that the fused route's backward (K4) gets its sender-ordered
copy. The proteins one-hot encoder (``use_one_hot_encoding``) concatenates
the node features with Linear(species one-hot).

Memory knobs (`deeper_gcn.py:62-76, 235, 271, 309, 325` there), both on
`nn.core.checkpoint_replay` (`torch.utils.checkpoint`, non-reentrant; the
recompute replays the dropout generator and leaves BatchNorm's running
statistics alone): ``remat`` recomputes each layer body after the first in
the backward; ``checkpoint_prologue`` recomputes, at train time, each
norm → relu → dropout prologue (res+) or epilogue (res, plain) instead of
keeping its masks. The port's default for ``checkpoint_prologue`` is False
(JAX's is True): the math is the same, and the port's chip numbers were
taken without it.

Not ported yet (the constructor raises on them): the bond edge modes, the
atom encoder, the virtual node and graph pooling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..convs.sparse import GENConv
from ..graph import Graph
from ..nn.core import Linear, checkpoint_replay, dropout, make_norm


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


# (field, value the port supports) — anything else is a later slice's work
_SUPPORTED = (("node_encoder", "linear"), ("graph_pooling", ""),
              ("add_virtual_node", False))
EDGE_MODES = ("none", "per_layer", "one_time")


class DeeperGCN(nn.Module):
    def __init__(self, cfg: DeeperGCNConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, value in _SUPPORTED:
            if getattr(cfg, name) != value:
                raise NotImplementedError(
                    f"DeeperGCNConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                    f"(this slice supports {value!r})")
        if cfg.block not in ("res+", "res", "plain"):
            raise NotImplementedError(f"Unknown block Type {cfg.block}")
        if cfg.edge_mode not in EDGE_MODES:
            raise NotImplementedError(f"DeeperGCNConfig.edge_mode={cfg.edge_mode!r} is not "
                                      f"ported yet (the port has {EDGE_MODES})")
        self.cfg = c = cfg
        if c.use_one_hot_encoding:
            self.node_one_hot_encoder = Linear(c.in_channels, c.in_channels,
                                               generator=generator)
        enc_in = c.node_feat_dim + c.in_channels if c.use_one_hot_encoding else c.in_channels
        self.node_features_encoder = Linear(enc_in, c.hidden_channels, generator=generator)
        self.gcns = nn.ModuleList(
            GENConv(c.hidden_channels, c.hidden_channels, aggr=c.aggr, t=c.t,
                    learn_t=c.learn_t, p=c.p, learn_p=c.learn_p, y=c.y,
                    learn_y=c.learn_y, msg_norm=c.msg_norm,
                    learn_msg_scale=c.learn_msg_scale,
                    encode_edge=c.edge_mode == "per_layer",
                    edge_feat_dim=c.edge_feat_dim or None, norm=c.norm,
                    mlp_layers=c.mlp_layers, compute_dtype=c.compute_dtype,
                    generator=generator)
            for _ in range(c.num_layers))
        self.norms = nn.ModuleList(make_norm(c.norm, c.hidden_channels)
                                   for _ in range(c.num_layers))
        self.node_pred_linear = Linear(c.hidden_channels, c.num_tasks,
                                       generator=generator)
        if c.edge_mode == "one_time":
            self.edge_encoder = Linear(c.edge_feat_dim, c.hidden_channels,
                                       generator=generator)

    def forward(self, x: torch.Tensor, g: Graph,
                generator: Optional[torch.Generator] = None,
                node_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [N_pad, num_tasks]; dropout masks come from ``generator``
        in training mode. With the one-hot encoder ``x`` is the species
        one-hot and ``node_feats`` the aggregated node features."""
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
        h = self.node_features_encoder(x)
        if carry is not None:
            h = h.to(carry)
        ee = {}
        if c.edge_mode == "one_time" and g.edge_attr is not None:
            ee["edge_emb"] = self.edge_encoder(g.edge_attr)
            if g.edge_attr_csc is not None:
                ee["edge_emb_csc"] = self.edge_encoder(g.edge_attr_csc)
        if c.block == "res+":
            h = self.gcns[0](h, g, **ee)
            if carry is not None:
                h = h.to(carry)

            def prologue(h, i):
                return drop(torch.relu(self.norms[i - 1](h, mask)))

            def body(h, i):
                h2 = ckpt(ckpt_pro, prologue, h, i)
                return h + self.gcns[i](h2, g, **ee).to(h.dtype)

            for i in range(1, c.num_layers):
                h = ckpt(c.remat, body, h, i)
            h = self.norms[c.num_layers - 1](h, mask)
            if c.final_relu:
                h = torch.relu(h)
            if c.final_dropout:
                h = drop(h)
        else:
            def epilogue(h1, h, i):
                h3 = torch.relu(self.norms[i](h1, mask))
                return drop(h3 + h if c.block == "res" else h3)

            def body(h, i):
                return ckpt(ckpt_pro, epilogue, self.gcns[i](h, g, **ee), h, i)

            for i in range(c.num_layers):
                h = ckpt(c.remat, body, h, i)
        return self.node_pred_linear(h)
