"""RevGCN, the reversible grouped GENConv backbone of GNN-1000 (counterpart of
`deep_gcns_torch_tpu/models/rev_gcn.py:31-174`, reference
`examples/ogb_eff/ogbn_proteins/model_rev.py:12-112`):

* per layer a `GroupAdditiveCoupling` of G `GENBlock`s on C/G channels each;
  the L layers run as one reversible stack with activation memory that does
  not grow with L (`rev/invertible.py`). RevGNN-Deep is L=1001, C=80, G=2;
* one shared dropout mask per forward, drawn from an explicit generator and
  chunked per group (`model_rev.py:101-102`);
* the edge features encoded once, Linear(8, C), and replicated G times in
  both edge orders (`:98-99`); each group's GENConv encodes its chunk down to
  C/G with its own edge encoder (the conv_encode_edge path);
* the head: last norm → relu → dropout → `node_pred_linear` (`:109-112`).

Parameter names follow the reference `state_dict` (`node_one_hot_encoder`,
`node_features_encoder`, `edge_encoder`, `gcns.{l}.Fms.{g}.norm`,
`gcns.{l}.Fms.{g}.gcn.*`, `last_norm`, `node_pred_linear`), except that the
reference's invertible wrapper adds `_fn.` between `gcns.{l}.` and `Fms`.
Only ``conv="gen"`` is ported; the GCN, SAGE and GAT group functions need
convs of later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..graph import Graph
from ..nn.core import Linear, dropout, make_norm, shared_dropout_mask
from ..rev.coupling import GroupAdditiveCoupling
from ..rev.invertible import reversible_stack
from ..rev.rev_layer import GENBlock


@dataclass(frozen=True)
class RevGCNConfig:
    in_channels: int = 8          # raw node features (species one-hot for proteins)
    node_feat_dim: int = 8        # aggregated edge-feature node features
    edge_feat_dim: int = 8
    hidden_channels: int = 80
    num_tasks: int = 112
    num_layers: int = 1001
    group: int = 2
    aggr: str = "mean"
    t: float = 1.0
    learn_t: bool = False
    p: float = 1.0
    learn_p: bool = False
    y: float = 0.0
    learn_y: bool = False
    msg_norm: bool = False
    learn_msg_scale: bool = False
    conv_encode_edge: bool = True
    norm: str = "layer"
    mlp_layers: int = 1
    dropout: float = 0.0
    use_one_hot_encoding: bool = True
    compute_dtype: str = "float32"
    conv: str = "gen"
    heads: int = 1


class RevGCN(nn.Module):
    def __init__(self, cfg: RevGCNConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.conv != "gen":
            raise NotImplementedError(f"RevGCN conv {cfg.conv!r} is not ported yet "
                                      "(the port has 'gen')")
        if cfg.hidden_channels % cfg.group:
            raise ValueError(f"{cfg.hidden_channels} channels do not split into "
                             f"{cfg.group} groups")
        self.cfg = c = cfg
        cg = c.hidden_channels // c.group
        if c.use_one_hot_encoding:
            self.node_one_hot_encoder = Linear(c.in_channels, c.in_channels,
                                               generator=generator)
        enc_in = c.node_feat_dim + (c.in_channels if c.use_one_hot_encoding else 0)
        self.node_features_encoder = Linear(enc_in, c.hidden_channels, generator=generator)
        # no edge features in the task (edge_feat_dim 0): no model-level encoder
        self.edge_encoder = (Linear(c.edge_feat_dim, c.hidden_channels, generator=generator)
                             if c.edge_feat_dim else None)
        self.gcns = nn.ModuleList(
            GroupAdditiveCoupling([
                GENBlock(cg, cg, aggr=c.aggr, t=c.t, learn_t=c.learn_t, p=c.p,
                         learn_p=c.learn_p, y=c.y, learn_y=c.learn_y, msg_norm=c.msg_norm,
                         learn_msg_scale=c.learn_msg_scale, encode_edge=c.conv_encode_edge,
                         edge_feat_dim=c.hidden_channels, norm=c.norm,
                         mlp_layers=c.mlp_layers, compute_dtype=c.compute_dtype,
                         generator=generator)
                for _ in range(c.group)])
            for _ in range(c.num_layers))
        self.last_norm = make_norm(c.norm, c.hidden_channels)
        self.node_pred_linear = Linear(c.hidden_channels, c.num_tasks, generator=generator)

    def forward(self, x: torch.Tensor, g: Graph, node_feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [N_pad, num_tasks]. ``x`` is the species one-hot and
        ``node_feats`` the aggregated node features; in training mode the
        shared and the head's dropout masks come from ``generator``."""
        c = self.cfg
        if c.use_one_hot_encoding:
            if node_feats is None:
                raise ValueError("use_one_hot_encoding needs node_feats")
            h_in = torch.cat([node_feats, self.node_one_hot_encoder(x)], 1)
        else:
            h_in = node_feats if node_feats is not None else x
        h = self.node_features_encoder(h_in)

        ee = ee_csc = None
        if g.edge_attr is not None and self.edge_encoder is not None:
            ee = self.edge_encoder(g.edge_attr).repeat(1, c.group)
            if g.edge_attr_csc is not None:
                ee_csc = self.edge_encoder(g.edge_attr_csc).repeat(1, c.group)

        mask = None
        if self.training and c.dropout > 0:
            mask = shared_dropout_mask(h.shape, c.dropout, generator, h.dtype)
        h = reversible_stack(self.gcns, h, g, (mask, ee, ee_csc))

        h = torch.relu(self.last_norm(h, g.node_mask))
        h = dropout(h, c.dropout, train=self.training, generator=generator)
        return self.node_pred_linear(h)
