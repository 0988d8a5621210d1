"""Pre-activation blocks inside reversible couplings (counterpart of
`deep_gcns_torch_tpu/rev/rev_layer.py:25-168`, reference
`eff_gcn_modules/rev/rev_layer.py:29-109`): norm → ReLU → shared dropout →
conv. The shared dropout mask is an explicit chunk argument, so the forward
and the inverse see the same mask by construction.

`GENBlock` is ported. `GCNBlock`, `SAGEBlock` and `GATBlock` need the
SemiGCN, SAGE and GAT convs of later slices and raise until then.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..convs.sparse import GENConv
from ..graph import Graph
from ..nn.core import make_norm


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
        mask, edge_attr, edge_attr_csc = (tuple(chunk_args) + (None,) * 3)[:3]
        h = torch.relu(self.norm(x, g.node_mask))
        if self.training and mask is not None:
            h = h * mask
        return self.gcn(h, g, edge_attr=edge_attr, edge_attr_csc=edge_attr_csc)


class GCNBlock(nn.Module):
    """Not ported yet: needs the SemiGCNConv of a later slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("GCNBlock needs the SemiGCNConv of a later slice")


class SAGEBlock(nn.Module):
    """Not ported yet: needs the RSAGEConv of a later slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("SAGEBlock needs the RSAGEConv of a later slice")


class GATBlock(nn.Module):
    """Not ported yet: needs the GATConv of a later slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("GATBlock needs the GATConv of a later slice")
