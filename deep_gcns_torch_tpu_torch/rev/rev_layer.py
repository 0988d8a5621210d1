"""Pre-activation blocks inside reversible couplings (counterpart of
`deep_gcns_torch_tpu/rev/rev_layer.py:25-168`, reference
`eff_gcn_modules/rev/rev_layer.py:29-109`): norm → ReLU → shared dropout →
conv. The shared dropout mask is an explicit chunk argument, so the forward
and the inverse see the same mask by construction.

`GENBlock` (GENConv), `GCNBlock` (Kipf's GCN), `SAGEBlock` (the
reference's SAGE) and `GATBlock` (PyG's GATConv without self loops). The
GCN and SAGE blocks read no edge features, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..convs.sparse import GATConv, GENConv, RSAGEConv, GCNConv
from ..graph import Graph
from ..nn.core import make_norm


def _pre(norm: nn.Module, x: torch.Tensor, g: Graph, chunk_args: Tuple,
         training: bool) -> torch.Tensor:
    """norm → relu → the shared dropout mask (the first chunk argument)."""
    mask = (tuple(chunk_args) + (None,))[0]
    h = torch.relu(norm(x, g.node_mask))
    return h * mask if training and mask is not None else h


class GENBlock(nn.Module):
    """norm → relu → shared dropout → GENConv (`rev_layer.py:54-77`). The
    chunk arguments are (dropout mask, edge features, their sender-ordered
    copy); the conv encodes the edge features with its own encoder."""

    def __init__(self, in_dim: int, out_dim: int, aggr: str = "softmax", t: float = 1.0,
                 learn_t: bool = False, p: float = 1.0, learn_p: bool = False,
                 y: float = 0.0, learn_y: bool = False, msg_norm: bool = False,
                 learn_msg_scale: bool = False, encode_edge: bool = False,
                 edge_feat_dim: int = 0, norm: str = "layer", mlp_layers: int = 1,
                 compute_dtype: str = "float32", generator=None):
        super().__init__()
        self.norm = make_norm(norm, in_dim)
        self.gcn = GENConv(in_dim, out_dim, aggr=aggr, t=t, learn_t=learn_t, p=p,
                           learn_p=learn_p, y=y, learn_y=learn_y, msg_norm=msg_norm,
                           learn_msg_scale=learn_msg_scale, encode_edge=encode_edge,
                           edge_feat_dim=edge_feat_dim or None, norm=norm,
                           mlp_layers=mlp_layers, compute_dtype=compute_dtype,
                           generator=generator)

    def forward(self, x: torch.Tensor, g: Graph, chunk_args: Tuple = ()) -> torch.Tensor:
        _, edge_attr, edge_attr_csc = (tuple(chunk_args) + (None,) * 3)[:3]
        h = _pre(self.norm, x, g, chunk_args, self.training)
        return self.gcn(h, g, edge_attr=edge_attr, edge_attr_csc=edge_attr_csc)


class GCNBlock(nn.Module):
    """norm → relu → shared dropout → Kipf's GCN (`rev_layer.py:81-104` of
    the JAX package, reference `rev_layer.py:80-85`), its PyG `GCNConv`
    parameters at `gcn.weight` and `gcn.bias`."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "layer", generator=None):
        super().__init__()
        self.norm = make_norm(norm, in_dim)
        self.gcn = GCNConv(in_dim, out_dim, generator=generator)

    def forward(self, x: torch.Tensor, g: Graph, chunk_args: Tuple = ()) -> torch.Tensor:
        return self.gcn(_pre(self.norm, x, g, chunk_args, self.training), g)


class SAGEBlock(nn.Module):
    """norm → relu → shared dropout → the reference's SAGE, plain messages,
    no act and no norm inside (`rev_layer.py:107-132` of the JAX package):
    `gcn.weight`, `gcn.bias`, `gcn.nn.0.*`."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "layer", generator=None):
        super().__init__()
        self.norm = make_norm(norm, in_dim)
        self.gcn = RSAGEConv(in_dim, out_dim, act=None, norm=None, relative=False,
                             generator=generator)

    def forward(self, x: torch.Tensor, g: Graph, chunk_args: Tuple = ()) -> torch.Tensor:
        return self.gcn(_pre(self.norm, x, g, chunk_args, self.training), g)


class GATBlock(nn.Module):
    """norm → relu → shared dropout → PyG GATConv without self loops (the
    reference's `add_self_loops=False`), heads averaged (`rev_layer.py:135-168`
    of the JAX package). The chunk arguments are (dropout mask, ...); edge
    features are not read."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1, norm: str = "layer",
                 generator=None):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.norm = make_norm(norm, in_dim)
        self.gcn = GATConv(in_dim, out_dim, heads=heads, act=None, norm=None, self_loops=False,
                           generator=generator)

    def forward(self, x: torch.Tensor, g: Graph, chunk_args: Tuple = ()) -> torch.Tensor:
        out = self.gcn(_pre(self.norm, x, g, chunk_args, self.training), g)
        return out.reshape(out.shape[0], self.heads, self.out_dim).mean(1)
