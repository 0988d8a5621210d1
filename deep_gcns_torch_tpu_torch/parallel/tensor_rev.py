"""Tensor (channel) parallelism for the reversible RevGCN (counterpart of
`deep_gcns_torch_tpu/parallel/tensor_rev.py:1-447`).

The grouped additive coupling splits the C channels into G group functions
of C/G each; the T ranks of a tp group split every group again, in the
group-major layout: rank d holds, for every group g, the channels
[g·C/G + d·c, g·C/G + (d+1)·c) with c = C/(G·T), concatenated group-major
(`tensor.split_grouped`). A rank's [N, C/T] array then chunks into its
groups as a single-process array does, so the port's coupling and its
reversible backward (`rev/coupling.py`, `rev/invertible.py`) run on the
local arrays unchanged; only the group function has a TP twin
(`TPGENBlock`, JAX `_fm_local`, `:205-243`):

* LayerNorm over the group's C/G channels: one all-reduce of the packed
  (Σx, Σx²) a call (`tensor._tp_layernorm`);
* relu, the shared dropout mask and the residual add: local;
* the per-group edge encoder Linear(C → C/G) is column-parallel (the
  replicated model-level edge table in, this rank's slice out), and the
  messages are gathered and aggregated by `generalized_aggregate(...,
  row_ptr=)`, K2's message form for the softmax family (K1 in the gather's
  backward when the graph has its CSC);
* the update Linear(C/G → C/G) is row-parallel: one `psum_scatter`.

So a group function issues one LayerNorm all-reduce and one `psum_scatter`
a pass; the backward's re-evaluations issue them again, in the same order on
every rank. As JAX's `_fm_local` takes the sender-ordered edge embeddings
and never reads them, the TP group function gets none: no CSC route here.

The one-hot encoder and the model-level edge encoder are replicated, the
node encoder, the last norm and the head's input are group-major slices
(`shard_rev_params`, JAX `:104-186`). `make_tp_mask` draws the
single-process RevGCN's shared and head dropout masks exactly as
`models/rev_gcn.py` draws them and keeps this rank's group-major slice, so a
TP step with the same generator seed is the single-process step. After the
backward the replicated leaves' gradients (one-hot and edge encoders, the
head's bias, t/p/y) are summed over tp (JAX `:415-423`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..convs.sparse import _DTYPES, _scalar
from ..graph import Graph
from ..models.rev_gcn import RevGCN, RevGCNConfig
from ..nn.core import Linear, shared_dropout_mask
from ..ops.gather import gather_src_auto
from ..ops.segment import generalized_aggregate
from ..rev.coupling import GroupAdditiveCoupling
from ..rev.invertible import reversible_stack
from ..utils.loss import cross_entropy
from . import comm
from .tensor import (TP_AGGRS, ChannelSharded, Rule, RowLinear, TPHead, TPLayerNorm,
                     shard_state_dict, split_grouped, unshard_state_dict)


def check_tp_rev_supported(cfg: RevGCNConfig):
    """JAX's `check_tp_rev_supported` (`tensor_rev.py:52-60`), raising
    ValueError."""
    if cfg.conv != "gen":
        raise ValueError(f"tensor-parallel RevGCN covers the GEN block, not {cfg.conv!r}")
    if cfg.norm != "layer":
        raise ValueError("reversible couplings need stateless norms (norm='layer')")
    if cfg.mlp_layers != 1:
        raise ValueError(f"tensor-parallel RevGCN covers mlp_layers 1, not {cfg.mlp_layers}")
    if cfg.msg_norm:
        raise ValueError("MsgNorm mixes the channels: tensor parallelism refuses it")
    if cfg.aggr not in TP_AGGRS:
        raise ValueError(f"tensor parallelism does not cover aggr={cfg.aggr!r}")


def rev_rule(key: str) -> Rule:
    """How each `RevGCN` `state_dict` entry splits (JAX `shard_rev_params`'s
    layout): group-major slices of the full-width entries, plain slices of
    the per-group ones, the encoders of raw inputs replicated."""
    parts = key.split(".")
    if parts[0] in ("node_one_hot_encoder", "edge_encoder"):
        return None
    if parts[0] in ("node_features_encoder", "last_norm"):
        return (0, True)
    if parts[0] == "node_pred_linear":
        return (1, True) if parts[1] == "weight" else None
    if parts[0] == "gcns":
        name = parts[4:]   # after gcns.{l}.Fms.{g}
        if name[0] == "norm":
            return (0, False)
        if name[:2] == ["gcn", "mlp"]:           # row-parallel update Linear
            return (1, False) if name[-1] == "weight" else (0, False)
        if name[:2] == ["gcn", "edge_encoder"]:  # column-parallel: output rows
            return (0, False)
        if name[:2] in (["gcn", "t"], ["gcn", "p"], ["gcn", "y"]):
            return None
    raise KeyError(f"no tensor-parallel layout for {key!r}")


def shard_rev_params(sd: Dict[str, torch.Tensor], t: int, cfg: RevGCNConfig
                     ) -> List[Dict[str, torch.Tensor]]:
    """`RevGCN(cfg)`'s `state_dict` → the T ranks' `TPRevGCN` ones."""
    check_tp_rev_supported(cfg)
    return shard_state_dict(sd, t, rev_rule, cfg.group)


def unshard_rev_params(sds: Sequence[Dict[str, torch.Tensor]], cfg: RevGCNConfig
                       ) -> Dict[str, torch.Tensor]:
    """The T ranks' `state_dict`s → the single-process `RevGCN`'s."""
    return unshard_state_dict(sds, rev_rule, cfg.group)


class _TPGENConvParams(nn.Module):
    """A group's GENConv on the channel shard, under GENConv's names:
    `mlp.0` (row-parallel), `edge_encoder` (column-parallel), t/p/y."""

    def __init__(self, cfg: RevGCNConfig, cg: int, t: int, group, eps: float = 1e-7):
        super().__init__()
        self.aggr, self.eps = cfg.aggr, eps
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.grad_w = cfg.learn_t and cfg.aggr in ("softmax", "softmax_sum")
        self.mlp = nn.Sequential(RowLinear(cg // t, cg, t, group))
        self.edge_encoder = (Linear(cfg.hidden_channels, cg // t, generator=torch.Generator())
                             if cfg.conv_encode_edge else None)
        _scalar(self, "t", cfg.t, self.grad_w)
        _scalar(self, "p", cfg.p, cfg.learn_p and cfg.aggr in ("power", "power_sum"))
        _scalar(self, "y", cfg.y, cfg.learn_y and cfg.aggr in ("softmax_sum", "power_sum"))


class TPGENBlock(nn.Module):
    """`rev_layer.GENBlock` on a group's channel slice: TP LayerNorm → relu →
    the shared mask → gathered messages (+ the encoded edge chunk) →
    relu + ε → aggregation → the row-parallel update. Chunk arguments:
    (dropout mask, edge features, unused)."""

    def __init__(self, cfg: RevGCNConfig, t: int, group):
        super().__init__()
        cg = cfg.hidden_channels // cfg.group
        self.norm = TPLayerNorm(cg // t, cg, group)
        self.gcn = _TPGENConvParams(cfg, cg, t, group)

    def forward(self, x: torch.Tensor, g, chunk_args: Tuple = ()) -> torch.Tensor:
        mask, edge_attr = (tuple(chunk_args) + (None, None))[:2]
        h = torch.relu(self.norm(x))
        if self.training and mask is not None:
            h = h * mask
        gcn = self.gcn
        cd = gcn.compute_dtype
        msg = gather_src_auto(h.to(cd), g)
        if edge_attr is not None:
            ee = gcn.edge_encoder(edge_attr) if gcn.edge_encoder is not None else edge_attr
            msg = msg + ee.to(cd)
        msg = torch.relu(msg) + torch.tensor(gcn.eps, dtype=cd)
        t = gcn.t if gcn.grad_w else gcn.t.detach()
        m = generalized_aggregate(msg, g.receivers, h.shape[0], aggr=gcn.aggr, t=t, p=gcn.p,
                                  y=gcn.y, learn_t=gcn.grad_w, mask=g.edge_mask,
                                  row_ptr=g.row_ptr).to(h.dtype)
        return gcn.mlp[0](h + m, cd if cd == torch.bfloat16 else None)


def make_tp_mask(cfg: RevGCNConfig, generator: Optional[torch.Generator], n: int, t: int,
                 index: int, dtype: torch.dtype = torch.float32
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """This rank's group-major slices of the single-process RevGCN's dropout
    masks (JAX `make_tp_mask`, `:366-381`): the shared mask
    (`nn.core.shared_dropout_mask`, [N, C]) and the head's keep mask (the
    bool draw of `nn.core.dropout` on [N, C]), drawn from ``generator`` in
    `models/rev_gcn.py`'s order. (None, None) without dropout."""
    if cfg.dropout <= 0:
        return None, None
    c = cfg.hidden_channels
    shared = shared_dropout_mask((n, c), cfg.dropout, generator, dtype)
    device = None if generator is None else generator.device
    keep = torch.rand((n, c), device=device, generator=generator) >= cfg.dropout
    return (split_grouped(shared, t, 1, cfg.group)[index],
            split_grouped(keep, t, 1, cfg.group)[index])


class TPRevGCN(ChannelSharded):
    """`RevGCN` (GEN blocks, LayerNorm) with its channels split over
    ``tp_group`` in the group-major layout (JAX `TPRevGCN`). ``model(x, g,
    node_feats, generator)`` on the whole graph gives the same logits on
    every rank; the weights are this rank's slices of `RevGCN(cfg,
    generator)`'s. In training the dropout masks are ``masks`` (this rank's
    (shared, head keep) slices) or, without them, `make_tp_mask`'s draw from
    ``generator``, which must then start alike on every tp rank."""

    def __init__(self, cfg: RevGCNConfig, tp_group=None,
                 generator: Optional[torch.Generator] = None):
        check_tp_rev_supported(cfg)
        super().__init__(tp_group, rev_rule)
        self.cfg = c = cfg
        self.channel_groups = c.group
        T = self.tp_size
        C = c.hidden_channels
        if C % (c.group * T):
            raise ValueError(f"{C} channels do not split into {c.group} groups over {T} ranks")
        gen = torch.Generator()
        if c.use_one_hot_encoding:
            self.node_one_hot_encoder = Linear(c.in_channels, c.in_channels, generator=gen)
        enc_in = c.node_feat_dim + (c.in_channels if c.use_one_hot_encoding else 0)
        self.node_features_encoder = Linear(enc_in, C // T, generator=gen)
        self.edge_encoder = (Linear(c.edge_feat_dim, C, generator=gen)
                             if c.edge_feat_dim else None)
        self.gcns = nn.ModuleList(
            GroupAdditiveCoupling([TPGENBlock(c, T, tp_group) for _ in range(c.group)])
            for _ in range(c.num_layers))
        self.last_norm = TPLayerNorm(C // T, C, tp_group)
        self.node_pred_linear = TPHead(C // T, c.num_tasks, tp_group)
        self.load_single_state_dict(RevGCN(c, generator=generator).state_dict())

    def forward(self, x: torch.Tensor, g: Graph, node_feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        c = self.cfg
        if c.use_one_hot_encoding:
            if node_feats is None:
                raise ValueError("use_one_hot_encoding needs node_feats")
            h_in = torch.cat([node_feats, self.node_one_hot_encoder(x)], 1)
        else:
            h_in = node_feats if node_feats is not None else x
        h = self.node_features_encoder(h_in)
        ee = None
        if g.edge_attr is not None and self.edge_encoder is not None:
            ee = self.edge_encoder(g.edge_attr).repeat(1, c.group)
        mask = keep = None
        if self.training and c.dropout > 0:
            mask, keep = masks if masks is not None else make_tp_mask(
                c, generator, h.shape[0], self.tp_size, self.tp_index, h.dtype)
        h = reversible_stack(self.gcns, h, g, (mask, ee))
        h = torch.relu(self.last_norm(h))
        if keep is not None:
            h = torch.where(keep, h / (1.0 - c.dropout), torch.zeros((), dtype=h.dtype,
                                                                       device=h.device))
        return self.node_pred_linear(h)


def tp_rev_train_step(model: TPRevGCN, opt: torch.optim.Optimizer, g: Graph,
                      x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      loss_fn: Callable = cross_entropy, *,
                      node_feats: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """One step (JAX `tp_rev_train_step`, `:404-447`): the loss on the
    replicated logits, the reversible backward, the replicated leaves'
    gradients summed over tp, this rank's optimizer step."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model(x, g, node_feats=node_feats, generator=generator, masks=masks),
                   labels, mask)
    loss.backward()
    comm.all_reduce_grads(model.replicated_parameters(), group=model.tp_group)
    opt.step()
    return loss.detach()


@torch.no_grad()
def tp_rev_forward(model: TPRevGCN, g: Graph, x: torch.Tensor,
                   node_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode logits, the same on every rank."""
    model.eval()
    return model(x, g, node_feats=node_feats)
