"""Module core: activations, Linear, embeddings, MLP, norms and dropout as
`torch.nn.Module`s.

Counterpart of `deep_gcns_torch_tpu/nn/core.py:42-440`. Parameter names follow
the reference `state_dict` (`weight`/`bias`, `running_mean`/`running_var`,
MLP children indexed like the reference's `nn.Sequential`, the Atom/Bond
encoders' `atom_embedding_list.{i}.weight`), so reference checkpoints and
goldens load with plain `load_state_dict`.

Two departures from `torch.nn`, both inherited from the JAX package:

* `BatchNorm` takes a row mask: padding rows (`Graph.node_mask` False) must
  not enter the batch statistics. `torch.nn.BatchNorm1d` would count them.
* `dropout` draws its mask from an explicit `torch.Generator` and keeps a
  bool mask for the backward (JAX redraws it from the key instead; the two
  frameworks' random streams differ, so parity tests use dropout 0).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

_STATS = threading.local()


@contextlib.contextmanager
def _frozen_running_stats():
    """Inside, `BatchNorm` in training mode normalises with the batch's
    statistics but leaves its running statistics as they are."""
    prev = getattr(_STATS, "frozen", False)
    _STATS.frozen = True
    try:
        yield
    finally:
        _STATS.frozen = prev


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


# ---------------------------------------------------------------------------
# activations (reference `gcn_lib/sparse/torch_nn.py:9-20` act_layer)
# ---------------------------------------------------------------------------

def activation(act: Optional[str], x: torch.Tensor, *, neg_slope: float = 0.2,
               prelu: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu / leakyrelu / prelu / none (`nn/core.py:57-77`). For "prelu" the
    slope is ``prelu`` (a module's learned one) when given, else the static
    ``neg_slope``."""
    if act is None or act.lower() == "none":
        return x
    a = act.lower()
    if a == "relu":
        return torch.relu(x)
    if a == "leakyrelu":
        return F.leaky_relu(x, neg_slope)
    if a == "prelu":
        slope = neg_slope if prelu is None else prelu.to(x.dtype)
        return torch.where(x >= 0, x, slope * x)
    raise NotImplementedError(f"activation layer [{act}] is not found")


def prelu_init(act: Optional[str], neg_slope: float = 0.2) -> Optional[nn.Parameter]:
    """The learned PReLU slope of a module whose activation is "prelu" (the
    reference's `nn.PReLU(num_parameters=1, init=neg_slope)`), else None."""
    if act is not None and act.lower() == "prelu":
        return nn.Parameter(torch.full((1,), neg_slope))
    return None


class PReLU(nn.Module):
    """PReLU with one learned slope `weight` (torch's name), initialised to
    ``init_slope``: where(x ≥ 0, x, a·x), as the JAX package computes it."""

    def __init__(self, init_slope: float = 0.2):
        super().__init__()
        self.weight = prelu_init("prelu", init_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activation("prelu", x, prelu=self.weight)


class Identity(nn.Module):
    """x as it is; further arguments (a mask) are ignored."""

    def forward(self, x: torch.Tensor, *args, **kw) -> torch.Tensor:
        return x


def act_layer(act: Optional[str], neg_slope: float = 0.2) -> Optional[nn.Module]:
    """String → activation module (reference `act_layer`), None for none."""
    if act is None or act.lower() == "none":
        return None
    a = act.lower()
    if a == "relu":
        return nn.ReLU()
    if a == "leakyrelu":
        return nn.LeakyReLU(neg_slope)
    if a == "prelu":
        return PReLU(neg_slope)
    raise NotImplementedError(f"activation layer [{act}] is not found")


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two 2-D tensors of one dtype, accumulated and returned in
    float32 with no rounding to the inputs' dtype (JAX's
    `preferred_element_type=float32`). bf16 on the card is one cuBLAS
    bf16×bf16→f32 product; on the CPU the bf16 values are exact in float32.
    float32 products run in full float32 (TF32 stays off)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """`mm_f32` with a backward (`aten::mm.dtype` has none), JAX's transpose
    rule of a product with `preferred_element_type=float32`: the float32
    cotangent meets the other (bf16-rounded) input widened to float32, with
    no rounding of the cotangent, and each gradient is rounded once to its
    input's dtype. On the card these are float32 products (TF32 off)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        da = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


class Linear(nn.Module):
    """y = x Wᵀ + b with torch's default init U(-1/√in, 1/√in).

    With ``compute_dtype`` x and W are rounded to that type (bf16 on the hot
    path), their product is accumulated and kept in float32 (`mm_f32`), and
    the float32 bias is added to it, as the JAX package's
    `preferred_element_type=float32` product does (`nn/core.py:174-179`)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        bound = 1.0 / math.sqrt(in_dim)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        if compute_dtype is not None:
            y = _MatmulF32.apply(x.to(compute_dtype), self.weight.to(compute_dtype).t())
        else:
            y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """A [num, dim] table `weight` (torch's name) with the reference
    encoders' Xavier-uniform init (fan_in = num, fan_out = dim)."""

    def __init__(self, num: int, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))
        _uniform_(self.weight, math.sqrt(6.0 / (num + dim)), generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), self.weight)


class MultiEmbedding(nn.Module):
    """Sum of per-column categorical embeddings, the reference's AtomEncoder /
    BondEncoder (`gcn_lib/sparse/torch_nn.py:74-113`): x [N, F] int → Σ_f
    table_f[x[:, f]]. ``list_name`` is the reference's attribute for the
    tables (`atom_embedding_list`, `bond_embedding_list`)."""

    def __init__(self, dims: Sequence[int], emb_dim: int, list_name: str = "embedding_list",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.list_name = list_name
        setattr(self, list_name, nn.ModuleList(Embedding(d, emb_dim, generator)
                                               for d in dims))

    @property
    def tables(self) -> nn.ModuleList:
        return getattr(self, self.list_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = 0
        for i, emb in enumerate(self.tables):
            out = out + emb(x[:, i])
        return out


class BatchNorm(nn.Module):
    """BatchNorm1d over the rows of [N, C] (eps 1e-5, momentum 0.1, affine)
    that ignores masked rows: one-pass masked moments with count = valid rows,
    biased variance in the normalisation, unbiased in the running variance.

    Across ranks (`sync_batch_norm`, the ``axis_name`` branch of JAX's
    `nn/core.py:285-290`) the training moments are the equal-weight means of
    the ranks' moments, E[x] and E[x²] = var + E[x]², and the count is the
    sum of the ranks' (clamped) counts, as JAX computes them; in a world of
    one the local moments are used as they are."""

    # moments across the ranks of ``rank_group`` (`sync_batch_norm`; None is
    # the default process group)
    cross_rank = False
    rank_group = None

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if self.training:
            if mask is not None:
                m = mask[:, None].to(x.dtype)
                xm = x * m
                cnt = torch.clamp_min(m.sum(), 1.0)
                mu = xm.sum(0) / cnt
                ex2 = (xm * x).sum(0) / cnt
            else:
                cnt = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
                mu = x.mean(0)
                ex2 = (x * x).mean(0)
            var = torch.clamp_min(ex2 - mu * mu, 0.0)
            if self.cross_rank:
                from ..parallel.comm import cross_rank_moments

                mu, var, cnt = cross_rank_moments(mu, var, cnt, self.rank_group)
            if not getattr(_STATS, "frozen", False):
                self._update_running(mu, var, cnt)
        else:
            mu, var = self.running_mean, self.running_var
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias

    @torch.no_grad()
    def _update_running(self, mu, var, cnt):
        unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
        self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mu)
        self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        self.num_batches_tracked.add_(1)


def sync_batch_norm(module: nn.Module, group=None) -> nn.Module:
    """Make every `BatchNorm` in ``module`` take its training moments across
    the ranks of ``group`` (a process group; None is the default one).
    Returns ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.cross_rank, m.rank_group = True, group
    return module


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (eps 1e-5, affine)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        mu = x.mean(-1, keepdim=True)
        var = torch.square(x - mu).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class InstanceNorm(nn.Module):
    """Non-affine normalisation over the (valid) rows, treating the whole row
    set as one instance, as the JAX package does for flat [N, C] node data."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is not None:
            m = mask[:, None].to(x.dtype)
            cnt = torch.clamp_min(m.sum(), 1.0)
            mu = (x * m).sum(0) / cnt
            var = (torch.square(x - mu) * m).sum(0) / cnt
        else:
            mu = x.mean(0)
            var = torch.square(x - mu).mean(0)
        return (x - mu) * torch.rsqrt(var + self.eps)


_NORMS = {"batch": BatchNorm, "layer": LayerNorm, "instance": InstanceNorm}
_NORM_TYPES = tuple(_NORMS.values())


def make_norm(norm: Optional[str], dim: int) -> Optional[nn.Module]:
    """String → norm module (reference `norm_layer`)."""
    if norm is None or str(norm).lower() == "none":
        return None
    try:
        return _NORMS[norm.lower()](dim)
    except KeyError:
        raise NotImplementedError(f"normalization layer [{norm}] is not found") from None


def dropout(x: torch.Tensor, rate: float, *, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (torch `F.dropout` semantics) with an explicit
    generator; autograd keeps only the bool keep-mask for the backward."""
    if not train or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def checkpoint_replay(fn: Callable, generator: Optional[torch.Generator], *args):
    """`torch.utils.checkpoint` of ``fn(*args)`` (non-reentrant): the
    backward recomputes ``fn`` instead of keeping its activations. The
    recompute draws the same dropout masks as the forward (it starts from
    the state that ``generator`` had before the forward and leaves the
    generator as it found it: checkpoint itself restores only the global
    RNGs) and leaves BatchNorm's running statistics alone (the forward
    updated them once)."""
    start = generator.get_state() if generator is not None else None
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        after = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(start)
        try:
            with _frozen_running_stats():
                return fn(*a)
        finally:
            if generator is not None:
                generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def shared_dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One Bernoulli keep-mask (keep probability 1 − rate) divided by
    (1 − rate), shared by all the layers of a reversible stack
    (`nn/core.py:146-150`, reference `model_rev.py:101-102`); drawn on the
    generator's device."""
    device = None if generator is None else generator.device
    keep = torch.rand(shape, device=device, generator=generator) < 1.0 - rate
    return keep.to(dtype) / (1.0 - rate)


class MLP(nn.Sequential):
    """Lin → norm → act per layer, a bare Lin last when ``last_lin``; child
    indices match the reference `nn.Sequential` (`mlp.0`, `mlp.1`, `mlp.3`;
    a PReLU's slope at `mlp.2.weight`). ``act`` relu (default), leakyrelu,
    prelu or none; no dropout inside (the JAX package's MLP drops only with
    ``drop`` > 0, which no ported configuration sets)."""

    def __init__(self, channels: Sequence[int], norm: Optional[str] = None,
                 bias: bool = True, last_lin: bool = False, act: Optional[str] = "relu",
                 generator: Optional[torch.Generator] = None):
        layers = []
        n = len(channels)
        for i in range(1, n):
            layers.append(Linear(channels[i - 1], channels[i], bias, generator))
            if i == n - 1 and last_lin:
                break
            nm = make_norm(norm, channels[i])
            if nm is not None:
                layers.append(nm)
            a = act_layer(act)
            if a is not None:
                layers.append(a)
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None):
        for layer in self:
            if isinstance(layer, Linear):
                x = layer(x, compute_dtype)
            elif isinstance(layer, _NORM_TYPES):
                x = layer(x, mask)
            else:
                x = layer(x)
        return x


@torch.no_grad()
def kaiming_reinit(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw every Linear weight kaiming-normal (std = √(2/in_dim)) and zero
    every Linear bias, the reference's `model_init` (`nn/core.py:414-433`);
    norms and embedding tables stay as they are. (The JAX rule re-draws any
    leaf named `w`, which is also a bare `Embedding`'s table; no model uses
    one there: the Atom/Bond encoders' `tables` and the virtual node's
    `vn_emb`, which it leaves alone, are its only tables.) Returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                       device=m.weight.device) * math.sqrt(2.0 / m.in_dim))
            if m.bias is not None:
                m.bias.zero_()
    return module


def init_all(modules: Sequence[Tuple[str, nn.Module]]) -> nn.ModuleDict:
    """Named modules → one `nn.ModuleDict` (`nn/core.py:436-440`: there a
    dict of per-module params and state; here the modules own theirs)."""
    return nn.ModuleDict(dict(modules))
