"""RevGAT, the reversible GAT of ogbn-arxiv (counterpart of
`deep_gcns_torch_tpu/models/rev_gat.py:36-239`, reference
`examples/ogb_eff/ogbn_arxiv_dgl/model_rev.py:197-365`):

* first and last layers: plain `SymGATConv`s with a residual;
* the L−2 middle layers: `GroupAdditiveCoupling`s of G `RevGATBlock`s (norm →
  ReLU → shared dropout → SymGATConv) run as one reversible stack, whose
  activation memory does not grow with L (`rev/invertible.py`);
* one shared dropout mask per forward, and one edge-drop key pair per layer,
  the same for every group of a layer (`model_rev.py:343-357`);
* the head: norm → ReLU → dropout → last conv → mean over heads → bias.

The in-block and head norms use the current batch's statistics over the
valid rows in both modes, as the JAX package does (the reference's
BatchNorm running statistics would be updated again by the reversible
recompute); so the port's `state_dict` has no running statistics.

Randomness comes from one explicit `torch.Generator`: the input dropout,
the shared dropout mask, the head's dropout and each layer's int32 drop-key
pair. ``forward`` also takes explicit ``drop_keys`` (the JAX package's
`drop_key_bits` values), so that edge-drop training can be held against JAX
bit for bit.

Parameter names follow the reference `state_dict` (`convs.{l}.fc.weight`,
`convs.{l}.Fms.{g}.norm.*`, `convs.{l}.Fms.{g}.conv.*`, `norm.*`,
`bias_last.bias`), without the `_fn.` of the reference's invertible wrapper.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..convs.dgl_gat import SymGATConv
from ..graph import Graph
from ..nn.core import dropout, shared_dropout_mask
from ..ops.norm_act import batch_norm_act
from ..rev.coupling import GroupAdditiveCoupling
from ..rev.invertible import reversible_stack
from ..utils.profiling import span

KeyPair = Tuple[int, int]


class BatchStatsNorm(nn.Module):
    """The norm → ReLU → dropout multiply of RevGAT's blocks and head as one
    Function (`ops/norm_act.py`, K11 on the card): affine normalisation by
    the current batch's column statistics over the valid rows
    (`_batch_stats_norm`, `models/rev_gat.py:36-43`), with the reference
    BatchNorm's names `weight` and `bias` and no state, then the ReLU and
    the multiply by ``mult`` (a float mask) or by ``keep`` / (1 − ``rate``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, mult: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None, rate: float = 0.0) -> torch.Tensor:
        return batch_norm_act(x, mask, self.weight, self.bias, mult=mult, keep=keep, rate=rate,
                              eps=self.eps)


class _Bias(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim))


class RevGATBlock(nn.Module):
    """norm → relu → shared dropout → SymGATConv with a residual, heads
    flattened (`model_rev.py:197-254`). The chunk arguments are (dropout
    mask, drop key): the key is this group's [2, 1] chunk of an int32 [2, G]
    tensor on the host."""

    def __init__(self, in_dim: int, out_dim: int, n_heads: int = 1, edge_drop: float = 0.0,
                 use_attn_dst: bool = True, use_symmetric_norm: bool = False,
                 compute_dtype: str = "float32", stabilizer: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = BatchStatsNorm(in_dim)
        self.conv = SymGATConv(in_dim, out_dim, n_heads, edge_drop=edge_drop,
                               use_attn_dst=use_attn_dst, residual=True,
                               use_symmetric_norm=use_symmetric_norm,
                               compute_dtype=compute_dtype, stabilizer=stabilizer,
                               generator=generator)

    def forward(self, x: torch.Tensor, g: Graph, chunk_args: Tuple = ()) -> torch.Tensor:
        mask, dk = (tuple(chunk_args) + (None, None))[:2]
        with span("block.norm"):
            h = self.norm(x, g.node_mask, mult=mask if self.training else None)
        drop_key = None if dk is None else (int(dk[0, 0]), int(dk[1, 0]))
        out = self.conv(h, g, train=self.training, drop_key=drop_key)
        return out.reshape(out.shape[0], -1)


@dataclass(frozen=True)
class RevGATConfig:
    in_feats: int
    n_classes: int = 40
    n_hidden: int = 256
    n_layers: int = 5
    n_heads: int = 3
    group: int = 2
    dropout: float = 0.75
    input_drop: float = 0.25
    edge_drop: float = 0.3
    use_attn_dst: bool = False
    use_symmetric_norm: bool = True
    compute_dtype: str = "float32"
    stabilizer: str = "auto"


def draw_drop_keys(generator: torch.Generator, n_layers: int
                   ) -> Tuple[KeyPair, List[KeyPair], KeyPair]:
    """One int32 key pair per layer from ``generator``: (first, middle
    [L−2], last), as host ints (one transfer when the generator is on the
    card)."""
    keys = torch.randint(-2 ** 31, 2 ** 31, (n_layers, 2), generator=generator,
                         device=generator.device, dtype=torch.int64)
    with span("host.sync"):
        keys = keys.tolist()
    pairs = [tuple(k) for k in keys]
    return pairs[0], pairs[1:-1], pairs[-1]


def _pair(k) -> KeyPair:
    a, b = (int(v) for v in k)
    return a, b


class RevGAT(nn.Module):
    def __init__(self, cfg: RevGATConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        hid = c.n_heads * c.n_hidden
        if hid % c.group or c.n_hidden % c.group:
            raise ValueError(f"{c.n_heads} x {c.n_hidden} channels do not split into "
                             f"{c.group} groups")
        if c.n_layers < 2:
            raise ValueError("RevGAT needs a first and a last layer")
        kw = dict(edge_drop=c.edge_drop, use_attn_dst=c.use_attn_dst,
                  use_symmetric_norm=c.use_symmetric_norm, compute_dtype=c.compute_dtype,
                  stabilizer=c.stabilizer, generator=generator)
        convs: List[nn.Module] = [SymGATConv(c.in_feats, c.n_hidden, c.n_heads, residual=True,
                                             **kw)]
        for _ in range(c.n_layers - 2):
            convs.append(GroupAdditiveCoupling([
                RevGATBlock(hid // c.group, c.n_hidden // c.group, c.n_heads, **kw)
                for _ in range(c.group)]))
        convs.append(SymGATConv(hid, c.n_classes, 1, residual=True, **kw))
        self.convs = nn.ModuleList(convs)
        self.norm = BatchStatsNorm(hid)
        self.bias_last = _Bias(c.n_classes)

    def forward(self, x: torch.Tensor, g: Graph, generator: Optional[torch.Generator] = None,
                drop_keys: Optional[Sequence] = None) -> torch.Tensor:
        """Logits [N_pad, n_classes]. In training mode the dropout masks come
        from ``generator`` (on x's device), and so do the edge-drop keys
        unless ``drop_keys`` = (first [2], middle [L−2, 2], last [2]) gives
        them; with edge_drop > 0 one of the two is required."""
        c = self.cfg
        train = self.training
        n = x.shape[0]
        h = dropout(x, c.input_drop, train=train, generator=generator)
        dk_first = dk_last = None
        layer_args = None
        if train and c.edge_drop > 0:
            if drop_keys is None and generator is None:
                raise ValueError("edge_drop > 0 in training needs a generator or drop_keys")
            if drop_keys is None:
                drop_keys = draw_drop_keys(generator, c.n_layers)
            first, mid, last = drop_keys
            dk_first, dk_last = _pair(first), _pair(last)
            # each layer's key, replicated across its groups (chunked along G)
            layer_args = [(torch.tensor(_pair(k), dtype=torch.int32)[:, None]
                           .repeat(1, c.group),) for k in mid]
        h = self.convs[0](h, g, train=train, drop_key=dk_first).reshape(n, -1)
        mask = None
        if train and c.dropout > 0:
            mask = shared_dropout_mask(h.shape, c.dropout, generator, h.dtype)
        h = reversible_stack(self.convs[1:-1], h, g, (mask,), layer_args)
        with span("block.norm"):
            keep = None
            if train and c.dropout > 0:  # `dropout`'s draw, before the fused multiply
                keep = torch.rand(h.shape, device=h.device, generator=generator) >= c.dropout
            h = self.norm(h, g.node_mask, keep=keep, rate=c.dropout)
        out = self.convs[-1](h, g, train=train, drop_key=dk_last)
        return out.mean(1) + self.bias_last.bias
