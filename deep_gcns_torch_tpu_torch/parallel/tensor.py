"""Tensor (channel) parallelism for DeeperGCN (counterpart of
`deep_gcns_torch_tpu/parallel/tensor.py:1-386`): the hidden channels are
split over the T ranks of a tp process group, the nodes are not.

GENConv is channel-parallel but for its update MLP and the head:

* the message relu(x_j) + ε, the generalized softmax/power aggregation
  (per-channel weights, scalar t/p/y), the res+ residual, relu, dropout and
  BatchNorm (per-channel moments over the nodes) run on this rank's
  channels alone;
* every MLP Linear is row-parallel: its input is this rank's channels, its
  full-width partial product is summed and split back to the output
  channels by one `comm.psum_scatter` (lin → norm → relu, as
  `nn.core.MLP`);
* LayerNorm reduces across the channels: one all-reduce of the packed
  (Σx, Σx²) pair a call, E[x²] − E[x]² clamped at 0, then rsqrt(var + eps)
  (`_tp_layernorm`, JAX `:67-78`: its one-pass form, not the port's
  two-pass `nn.core.LayerNorm`);
* the head is row-parallel: each rank's h_loc W_locᵀ + b/T is summed by
  `comm.all_reduce_replicated` into the same logits on every rank, whose
  cotangent is passed through (each rank computes the same loss).

The aggregation gathers the messages and runs
`generalized_aggregate(..., row_ptr=)`, as JAX does (`tensor.py:233-238`):
K2's message form for the softmax family and K1 for the sums, with K1's
gathered form in the gather's backward when the graph carries its CSC
(`ops.gather.gather_src_auto`). The models follow the single-process
port in casting to ``compute_dtype`` (JAX's TP models skip it).

Parameters are this rank's slices of the single-process `DeeperGCN`'s,
under its `state_dict` names (`shard_deeper_params`, JAX `:108-163`): the
encoder split by its output rows, the head's weight by its input columns
with its bias replicated, every MLP Linear on its input axis with its bias
on the output shard, the norms and their running statistics by channel,
t/p/y replicated. A model is built from the single-process model of the
same seed, so a TP run starts from that model's weights; after a backward,
`tp_train_step` sums the replicated leaves' gradients over tp (JAX
`:358-365`) and each rank's optimizer steps its own slices.

Dropout draws from the rank's own generator, so the masks differ from the
single-process model's (JAX folds (layer, device) into its key); the
parity tests run without dropout. ``remat`` recomputes each layer in the
backward (`nn.core.checkpoint_replay`), re-issuing its `psum_scatter`s in
the same order on every rank; ``checkpoint_prologue`` is not read (the math
is the same, as in JAX's TP). Scope, as JAX's: res+, a linear node encoder,
``mlp_layers`` 1 or 2, batch/none/layer norms, no MsgNorm, no one-hot
input, edge features, virtual node or pooling (`check_tp_supported`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..convs.sparse import _DTYPES, _scalar
from ..graph import Graph
from ..models.deeper_gcn import DeeperGCN, DeeperGCNConfig
from ..nn.core import BatchNorm, Linear, _MatmulF32, checkpoint_replay, dropout
from ..ops.gather import gather_src_auto
from ..ops.segment import generalized_aggregate
from ..utils.loss import cross_entropy
from . import comm

TP_AGGRS = ("softmax", "softmax_sg", "softmax_sum", "add", "sum", "mean", "power", "power_sum",
            "max", "min")

# how a `state_dict` entry splits over the tp ranks: (dim, group-major) or
# None for an entry every rank holds whole
Rule = Optional[Tuple[int, bool]]


def check_tp_supported(cfg: DeeperGCNConfig):
    """JAX's `check_tp_supported` (`tensor.py:95-105`), raising ValueError,
    and the scope its sharding assumes."""
    if cfg.block != "res+":
        raise ValueError(f"tensor parallelism covers the res+ block, not {cfg.block!r}")
    if cfg.mlp_layers not in (1, 2):
        raise ValueError(f"tensor parallelism covers mlp_layers 1 and 2, not {cfg.mlp_layers}")
    if cfg.norm not in ("batch", "none", "layer"):
        raise ValueError(f"tensor parallelism supports batch/none/layer norms, not {cfg.norm!r}")
    if cfg.msg_norm:
        raise ValueError("MsgNorm mixes the channels: tensor parallelism refuses it")
    if cfg.aggr not in TP_AGGRS:
        raise ValueError(f"tensor parallelism does not cover aggr={cfg.aggr!r}")
    if (cfg.node_encoder != "linear" or cfg.use_one_hot_encoding or cfg.edge_mode != "none"
            or cfg.add_virtual_node or cfg.graph_pooling):
        raise ValueError("tensor parallelism covers a linear node encoder without one-hot "
                         "input, edge features, virtual node or pooling")


# ---------------------------------------------------------------------------
# host-side sharding of a `state_dict`
# ---------------------------------------------------------------------------

def split_grouped(a: torch.Tensor, t: int, dim: int, group: int) -> List[torch.Tensor]:
    """A full channel axis of G group-major chunks → T slices, slice d holding
    each group's d-th sub-slice, group-major (JAX `_split_grouped`,
    `tensor_rev.py:74-87`), so a slice chunks into its groups as a
    single-process tensor does."""
    c = a.shape[dim]
    if c % (group * t):
        raise ValueError(f"{c} channels do not split into {group} groups over {t} ranks")
    blocks = a.reshape(a.shape[:dim] + (group, t, c // (group * t)) + a.shape[dim + 1:])
    return [blocks.select(dim + 1, d).reshape(a.shape[:dim] + (c // t,) + a.shape[dim + 1:])
            .contiguous() for d in range(t)]


def cat_grouped(parts: Sequence[torch.Tensor], dim: int, group: int) -> torch.Tensor:
    """The inverse of `split_grouped`."""
    t, loc = len(parts), parts[0].shape[dim]
    blocks = [p.reshape(p.shape[:dim] + (group, loc // group) + p.shape[dim + 1:])
              for p in parts]
    full = torch.stack(blocks, dim + 1)   # [..., G, T, loc/G, ...]
    return full.reshape(full.shape[:dim] + (t * loc,) + full.shape[dim + 3:]).contiguous()


def shard_state_dict(sd: Dict[str, torch.Tensor], t: int, rule: Callable[[str], Rule],
                     group: int = 1) -> List[Dict[str, torch.Tensor]]:
    """A single-process `state_dict` → one per tp rank, each entry split as
    ``rule(name)`` says (``group`` for the group-major entries)."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(t)]
    for k, v in sd.items():
        r = rule(k)
        if r is None:
            parts = [v.clone() for _ in range(t)]
        else:
            dim, grouped = r
            if v.shape[dim] % t:
                raise ValueError(f"{k}: {v.shape[dim]} channels do not split over {t} ranks")
            parts = (split_grouped(v, t, dim, group) if grouped
                     else [c.contiguous() for c in torch.chunk(v, t, dim)])
        for d in range(t):
            out[d][k] = parts[d]
    return out


def unshard_state_dict(sds: Sequence[Dict[str, torch.Tensor]], rule: Callable[[str], Rule],
                       group: int = 1) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_state_dict`: the single-process `state_dict`."""
    out = {}
    for k, v in sds[0].items():
        r = rule(k)
        if r is None:
            out[k] = v.clone()
            continue
        dim, grouped = r
        parts = [sd[k] for sd in sds]
        out[k] = cat_grouped(parts, dim, group) if grouped else torch.cat(parts, dim)
    return out


def _mlp_linear_children(cfg) -> Tuple[int, ...]:
    """The `nn.Sequential` indices of GENConv's MLP Linears (`nn.core.MLP`:
    lin, norm, act per hidden layer, a bare last lin)."""
    norm = cfg.norm not in (None, "none")
    return (0,) if cfg.mlp_layers == 1 else (0, 3 if norm else 2)


def deeper_rule(cfg: DeeperGCNConfig) -> Callable[[str], Rule]:
    """How each `DeeperGCN(cfg)` `state_dict` entry splits (JAX
    `shard_deeper_params`'s layout, `tensor.py:108-163`)."""
    linears = _mlp_linear_children(cfg)

    def rule(key: str) -> Rule:
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            return None
        if parts[0] == "node_features_encoder":
            return (0, False)                     # column-parallel: output rows
        if parts[0] == "node_pred_linear":
            return (1, False) if parts[1] == "weight" else None
        if parts[0] == "norms":
            return (0, False)
        if parts[0] == "gcns" and parts[2] == "mlp":
            if int(parts[3]) in linears:          # row-parallel Linear
                return (1, False) if parts[4] == "weight" else (0, False)
            return (0, False)                     # the MLP's inter-layer norm
        if parts[0] == "gcns" and parts[2] in ("t", "p", "y"):
            return None
        raise KeyError(f"no tensor-parallel layout for {key!r}")

    return rule


def shard_deeper_params(sd: Dict[str, torch.Tensor], t: int, cfg: DeeperGCNConfig
                        ) -> List[Dict[str, torch.Tensor]]:
    """`DeeperGCN(cfg)`'s `state_dict` → the T ranks' `TPDeeperGCN` ones."""
    check_tp_supported(cfg)
    return shard_state_dict(sd, t, deeper_rule(cfg))


def unshard_deeper_params(sds: Sequence[Dict[str, torch.Tensor]], cfg: DeeperGCNConfig
                          ) -> Dict[str, torch.Tensor]:
    """The T ranks' `state_dict`s → the single-process `DeeperGCN`'s."""
    return unshard_state_dict(sds, deeper_rule(cfg))


# ---------------------------------------------------------------------------
# the channel-sharded layers
# ---------------------------------------------------------------------------

def _tp_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, c_full: int,
                  group, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over channels split across ``group``: one all-reduce of the
    packed (Σx, Σx²) [N, 2] a call (JAX `_tp_layernorm`)."""
    stats = comm.all_reduce_sum(torch.stack([x.sum(-1), torch.square(x).sum(-1)], -1), group)
    mu = stats[:, 0:1] / c_full
    var = torch.clamp_min(stats[:, 1:2] / c_full - torch.square(mu), 0.0)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


class TPLayerNorm(nn.Module):
    """LayerNorm of a channel slice (`weight`/`bias` of this rank's
    channels) normalising over the ``c_full`` channels of the group."""

    def __init__(self, dim: int, c_full: int, group, eps: float = 1e-5):
        super().__init__()
        self.c_full, self.group, self.eps = c_full, group, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _tp_layernorm(x, self.weight, self.bias, self.c_full, self.group, self.eps)


def tp_norm(norm: str, dim: int, c_full: int, group) -> Optional[nn.Module]:
    """The norm of a channel slice: BatchNorm (per channel, local),
    `TPLayerNorm`, or None."""
    if norm == "batch":
        return BatchNorm(dim)
    if norm == "layer":
        return TPLayerNorm(dim, c_full, group)
    return None


class RowLinear(nn.Module):
    """A row-parallel Linear(in_full → out_full) on this rank's ``in_loc``
    input channels: `weight` [out_full, in_loc], `bias` [out_full / T] of its
    output shard. x_loc W_locᵀ (float32 with ``compute_dtype``, as
    `nn.core.Linear`) is summed over the ranks and split back by one
    `comm.psum_scatter` (JAX `tp_mlp_apply`, `tensor.py:178-181`)."""

    def __init__(self, in_loc: int, out_full: int, t: int, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(torch.zeros(out_full, in_loc))
        self.bias = nn.Parameter(torch.zeros(out_full // t))

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        if compute_dtype is not None:
            y = _MatmulF32.apply(x.to(compute_dtype), self.weight.to(compute_dtype).t())
        else:
            y = F.linear(x, self.weight)
        return comm.psum_scatter(y, 1, self.group) + self.bias


class TPMLP(nn.Sequential):
    """GENConv's update MLP on the channel shard, its children numbered as
    `nn.core.MLP`'s (`mlp.0`, `mlp.1`, `mlp.3`): row-parallel Linears, each
    hidden one followed by its norm on the output shard and relu."""

    def __init__(self, channels: Sequence[int], norm: str, t: int, group):
        layers: List[nn.Module] = []
        n = len(channels)
        for i in range(1, n):
            layers.append(RowLinear(channels[i - 1] // t, channels[i], t, group))
            if i == n - 1:
                break
            nm = tp_norm(norm, channels[i] // t, channels[i], group)
            if nm is not None:
                layers.append(nm)
            layers.append(nn.ReLU())
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None):
        for layer in self:
            if isinstance(layer, RowLinear):
                x = layer(x, compute_dtype)
            elif isinstance(layer, nn.ReLU):
                x = layer(x)
            else:
                x = layer(x, mask)
        return x


class TPHead(nn.Module):
    """The row-parallel head: `weight` [tasks, C/T], `bias` [tasks]
    replicated; each rank adds b/T inside the sum (JAX `tensor.py:311-313`)
    and `comm.all_reduce_replicated` gives every rank the logits."""

    def __init__(self, in_loc: int, tasks: int, group):
        super().__init__()
        self.group = group
        self.tp_size = comm.world_size(group)
        self.weight = nn.Parameter(torch.zeros(tasks, in_loc))
        self.bias = nn.Parameter(torch.zeros(tasks))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce_replicated(F.linear(h, self.weight) + self.bias / self.tp_size,
                                          self.group)


class TPGENConv(nn.Module):
    """GENConv's parameters on the channel shard: `mlp` (a `TPMLP`) and
    t/p/y (replicated), under GENConv's names."""

    def __init__(self, cfg, c: int, t: int, group, eps: float = 1e-7):
        super().__init__()
        self.aggr, self.eps = cfg.aggr, eps
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.grad_w = cfg.learn_t and cfg.aggr in ("softmax", "softmax_sum")
        chans = [c] + [c * 2] * (cfg.mlp_layers - 1) + [c]
        self.mlp = TPMLP(chans, cfg.norm, t, group)
        _scalar(self, "t", cfg.t, self.grad_w)
        _scalar(self, "p", cfg.p, cfg.learn_p and cfg.aggr in ("power", "power_sum"))
        _scalar(self, "y", cfg.y, cfg.learn_y and cfg.aggr in ("softmax_sum", "power_sum"))

    def aggregate(self, msg_src: torch.Tensor, receivers, n: int, mask, row_ptr):
        """relu(x_j) + ε of the gathered rows, aggregated per receiver."""
        cd = self.compute_dtype
        msg = torch.relu(msg_src) + torch.tensor(self.eps, dtype=cd)
        t = self.t if self.grad_w else self.t.detach()
        return generalized_aggregate(msg, receivers, n, aggr=self.aggr, t=t, p=self.p,
                                     y=self.y, learn_t=self.grad_w, mask=mask,
                                     row_ptr=row_ptr)

    def update(self, x: torch.Tensor, m: torch.Tensor, node_mask) -> torch.Tensor:
        cd = self.compute_dtype
        return self.mlp(x + m.to(x.dtype), node_mask, cd if cd == torch.bfloat16 else None)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class ChannelSharded(nn.Module):
    """A model whose `state_dict` entries are this tp rank's slices of a
    single-process model's, split as ``split_rule(name)`` says (group-major
    over ``channel_groups`` groups where the rule says so)."""

    channel_groups = 1

    def __init__(self, tp_group, split_rule: Callable[[str], Rule]):
        super().__init__()
        self.tp_group, self.split_rule = tp_group, split_rule
        self.tp_size = comm.world_size(tp_group)
        self.tp_index = comm.rank_of(tp_group)

    def load_single_state_dict(self, sd: Dict[str, torch.Tensor]):
        """Load this rank's slices of a single-process `state_dict`."""
        mine = shard_state_dict(sd, self.tp_size, self.split_rule,
                                self.channel_groups)[self.tp_index]
        dev = next(self.parameters()).device
        self.load_state_dict({k: v.to(dev) for k, v in mine.items()})

    def single_state_dict(self) -> Dict[str, torch.Tensor]:
        """The single-process `state_dict` on every rank (a collective: one
        all-gather over tp of each split entry, in `state_dict` order)."""
        out = {}
        for k, v in self.state_dict().items():
            r = self.split_rule(k)
            if r is None:
                out[k] = v.detach().clone()
                continue
            dim, grouped = r
            full = comm._all_gather(v.detach().contiguous(), self.tp_group, dim)
            if grouped:
                full = cat_grouped(list(torch.chunk(full, self.tp_size, dim)), dim,
                                   self.channel_groups)
            out[k] = full
        return out

    def replicated_parameters(self) -> List[nn.Parameter]:
        """The parameters every rank holds whole (the head's bias, learned
        t/p/y, the encoders of raw inputs), whose gradients are partial on
        each rank and are summed over tp after the backward."""
        return [p for k, p in self.named_parameters()
                if p.requires_grad and self.split_rule(k) is None]


class TPDeeperGCN(ChannelSharded):
    """`DeeperGCN` (res+) with its channels split over ``tp_group`` (JAX
    `TPDeeperGCN`, `tensor.py:203-322`). ``model(x, g, generator)`` on the
    whole graph gives the same logits [N_pad, tasks] on every rank. The
    weights are this rank's slices of `DeeperGCN(cfg, generator)`'s."""

    def __init__(self, cfg: DeeperGCNConfig, tp_group=None,
                 generator: Optional[torch.Generator] = None):
        check_tp_supported(cfg)
        super().__init__(tp_group, deeper_rule(cfg))
        self.cfg = c = cfg
        T = self.tp_size
        C = c.hidden_channels
        if C % T:
            raise ValueError(f"{C} hidden channels do not split over {T} ranks")
        self.node_features_encoder = Linear(c.in_channels, C // T, generator=torch.Generator())
        self.gcns = nn.ModuleList(TPGENConv(c, C, T, tp_group) for _ in range(c.num_layers))
        self.norms = nn.ModuleList(
            tp_norm(c.norm, C // T, C, tp_group) or nn.Identity() for _ in range(c.num_layers))
        self.node_pred_linear = TPHead(C // T, c.num_tasks, tp_group)
        self.load_single_state_dict(DeeperGCN(c, generator=generator).state_dict())

    def _norm(self, i: int, h: torch.Tensor, mask) -> torch.Tensor:
        nrm = self.norms[i]
        return h if isinstance(nrm, nn.Identity) else nrm(h, mask)

    def _conv(self, i: int, h: torch.Tensor, g) -> torch.Tensor:
        """Layer i's GENConv on this rank's channels of the whole graph."""
        conv = self.gcns[i]
        n = h.shape[0]
        m = conv.aggregate(gather_src_auto(h.to(conv.compute_dtype), g), g.receivers, n,
                           g.edge_mask, g.row_ptr)
        return conv.update(h, m, g.node_mask)

    def forward(self, x: torch.Tensor, g, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.cfg
        train = self.training
        mask = g.node_mask
        carry = torch.bfloat16 if c.residual_dtype == "bfloat16" else None

        def drop(h):
            return dropout(h, c.dropout, train=train, generator=generator)

        h = self.node_features_encoder(x)
        if carry is not None:
            h = h.to(carry)
        h = self._conv(0, h, g)
        if carry is not None:
            h = h.to(carry)

        def body(h, i):
            h2 = drop(torch.relu(self._norm(i - 1, h, mask)))
            return h + self._conv(i, h2, g).to(h.dtype)

        for i in range(1, c.num_layers):
            if c.remat and torch.is_grad_enabled():
                h = checkpoint_replay(body, generator, h, i)
            else:
                h = body(h, i)
        h = self._norm(c.num_layers - 1, h, mask)
        if c.final_relu:
            h = torch.relu(h)
        if c.final_dropout:
            h = drop(h)
        return self.node_pred_linear(h)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def tp_train_step(model: TPDeeperGCN, opt: torch.optim.Optimizer, g: Graph, x: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor,
                  loss_fn: Callable = cross_entropy, *,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One full-batch step (JAX `tp_train_step`, `tensor.py:325-386`): the
    loss on the replicated logits, its backward (the channel-sharded
    gradients stay on their rank), the replicated leaves' gradients summed
    over tp, this rank's optimizer step. Returns the loss (the same on every
    rank)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model(x, g, generator), labels, mask)
    loss.backward()
    comm.all_reduce_grads(model.replicated_parameters(), group=model.tp_group)
    opt.step()
    return loss.detach()


@torch.no_grad()
def tp_forward(model: TPDeeperGCN, g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits [N_pad, tasks], the same on every rank."""
    model.eval()
    return model(x, g)
