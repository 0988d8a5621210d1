"""GENConv and MsgNorm (counterpart of `deep_gcns_torch_tpu/convs/sparse.py:55-247`).

Routing of the aggregation, in the JAX package's order
(`convs/sparse.py:167-236`):

* with a band attached that passes `band_ok` (`ops/band.py`), the softmax
  family goes to `band_softmax_agg_auto` (K3, K1 for the leftover, dense hub
  products) and add, sum, mean, power and power_sum to `band_sum_auto` on a
  node table;
* otherwise the softmax family (softmax, softmax_sg, softmax_sum) goes to
  `fused_softmax_gather_agg`, which launches K2 (and K1 in the backward);
* every other aggregator (max and min always) gathers the messages and runs
  the plain `generalized_aggregate`.

On a CPU tensor every kernel runs its plain version. Edge features
(per-layer edge encoders, embeddings fed from the model) and the band
max/min route (`band_extreme`) belong to later slices; edge features raise
`NotImplementedError`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..graph import Graph
from ..nn.core import MLP
from ..ops.band import BAND_SOFTMAX_AGGRS, band_ok, band_softmax_agg_auto, band_sum_auto
from ..ops.segment import generalized_aggregate, segment_degree
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
    """DeeperGCN generalized conv: msg = relu(x_j) + ε, generalized softmax /
    power-mean aggregation, update h = MLP(x + m)."""

    def __init__(self, in_dim: int, emb_dim: int, aggr: str = "softmax",
                 t: float = 1.0, learn_t: bool = False, p: float = 1.0,
                 learn_p: bool = False, y: float = 0.0, learn_y: bool = False,
                 msg_norm: bool = False, learn_msg_scale: bool = True,
                 encode_edge: bool = False, norm: str = "batch", mlp_layers: int = 2,
                 eps: float = 1e-7, compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if encode_edge:
            raise NotImplementedError("GENConv edge encoders come with the "
                                      "edge-feature slice of the port")
        self.aggr, self.eps = aggr, eps
        self.compute_dtype = _DTYPES[compute_dtype]
        self.grad_w = learn_t and aggr in ("softmax", "softmax_sum")
        chans = [in_dim] + [in_dim * 2] * (mlp_layers - 1) + [emb_dim]
        self.mlp = MLP(chans, norm=norm, last_lin=True, generator=generator)
        _scalar(self, "t", t, self.grad_w)
        _scalar(self, "p", p, learn_p and aggr in ("power", "power_sum"))
        _scalar(self, "y", y, learn_y and aggr in ("softmax_sum", "power_sum"))
        self.msg_norm = MsgNorm(learn_msg_scale) if msg_norm else None

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        if g.edge_attr is not None:
            raise NotImplementedError("GENConv with edge features comes with the "
                                      "edge-feature slice of the port")
        n = x.shape[0]
        cd = self.compute_dtype
        xc = x.to(cd)
        band = band_ok(g, self.aggr)
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
        elif self.aggr in SOFTMAX_AGGRS:
            m = fused_softmax_gather_agg_auto(
                xc.contiguous(), g.senders, g.row_ptr, g.csc_receivers, g.csc_col_ptr,
                t, self.eps, self.grad_w)
            if self.aggr == "softmax_sum":
                deg = segment_degree(g.receivers, n, g.edge_mask)
                m = torch.pow(deg, torch.sigmoid(self.y))[:, None].to(m.dtype) * m
        else:
            send = torch.clamp(g.senders.long(), max=n - 1)
            msg = torch.relu(xc.index_select(0, send)) + torch.tensor(self.eps, dtype=cd)
            m = generalized_aggregate(
                msg, g.receivers, n, aggr=self.aggr, t=self.t, p=self.p, y=self.y,
                mask=g.edge_mask)
        m = m.to(x.dtype)
        if self.msg_norm is not None:
            m = self.msg_norm(x, m)
        return self.mlp(x + m, g.node_mask,
                        cd if cd == torch.bfloat16 else None)
