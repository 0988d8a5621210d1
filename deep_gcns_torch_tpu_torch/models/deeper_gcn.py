"""DeeperGCN backbone: GENConv with res+/res/plain blocks (counterpart of
`deep_gcns_torch_tpu/models/deeper_gcn.py:31-337`).

The JAX package runs the layer stack under `lax.scan` over stacked per-layer
parameters; here it is a Python loop over `nn.ModuleList`s whose names follow
the reference `state_dict` (`node_features_encoder`, `gcns.{i}.mlp.0`,
`gcns.{i}.t` when learned, `norms.{i}`, `node_pred_linear`).

Block semantics (reference `examples/ogb/ogbn_arxiv/model.py:84-136`):
  res+ : h ← gcn_l( drop( relu( norm_{l-1}(h) ) ) ) + h   (pre-activation)
  res  : h ← relu( norm_l( gcn_l(h) ) ) + h, then dropout
  plain: h ← drop( relu( norm_l( gcn_l(h) ) ) )

Not in this slice (the constructor raises on them): edge features
(`edge_mode` other than "none"), the atom encoder, the one-hot encoder, the
virtual node, graph pooling, and the memory knobs `remat` and
`checkpoint_prologue`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..convs.sparse import GENConv
from ..graph import Graph
from ..nn.core import Linear, dropout, make_norm


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


# (field, value this slice supports) — anything else is a later slice's work
_SUPPORTED = (("node_encoder", "linear"), ("edge_mode", "none"), ("graph_pooling", ""),
              ("remat", False), ("add_virtual_node", False),
              ("checkpoint_prologue", False), ("use_one_hot_encoding", False))


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
        self.cfg = c = cfg
        self.node_features_encoder = Linear(c.in_channels, c.hidden_channels,
                                            generator=generator)
        self.gcns = nn.ModuleList(
            GENConv(c.hidden_channels, c.hidden_channels, aggr=c.aggr, t=c.t,
                    learn_t=c.learn_t, p=c.p, learn_p=c.learn_p, y=c.y,
                    learn_y=c.learn_y, msg_norm=c.msg_norm,
                    learn_msg_scale=c.learn_msg_scale, norm=c.norm,
                    mlp_layers=c.mlp_layers, compute_dtype=c.compute_dtype,
                    generator=generator)
            for _ in range(c.num_layers))
        self.norms = nn.ModuleList(make_norm(c.norm, c.hidden_channels)
                                   for _ in range(c.num_layers))
        self.node_pred_linear = Linear(c.hidden_channels, c.num_tasks,
                                       generator=generator)

    def forward(self, x: torch.Tensor, g: Graph,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [N_pad, num_tasks]; dropout masks come from ``generator``
        in training mode."""
        c = self.cfg
        train = self.training
        mask = g.node_mask
        carry = torch.bfloat16 if c.residual_dtype == "bfloat16" else None

        def drop(h):
            return dropout(h, c.dropout, train=train, generator=generator)

        h = self.node_features_encoder(x)
        if carry is not None:
            h = h.to(carry)
        if c.block == "res+":
            h = self.gcns[0](h, g)
            if carry is not None:
                h = h.to(carry)
            for i in range(1, c.num_layers):
                h2 = drop(torch.relu(self.norms[i - 1](h, mask)))
                h = h + self.gcns[i](h2, g).to(h.dtype)
            h = self.norms[c.num_layers - 1](h, mask)
            if c.final_relu:
                h = torch.relu(h)
            if c.final_dropout:
                h = drop(h)
        else:
            for i in range(c.num_layers):
                h3 = torch.relu(self.norms[i](self.gcns[i](h, g), mask))
                h = drop(h3 + h if c.block == "res" else h3)
        return self.node_pred_linear(h)
