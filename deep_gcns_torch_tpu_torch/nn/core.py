"""Module core: Linear, MLP, norms and dropout as `torch.nn.Module`s.

Counterpart of `deep_gcns_torch_tpu/nn/core.py:42-410`. Parameter names follow
the reference `state_dict` (`weight`/`bias`, `running_mean`/`running_var`,
MLP children indexed like the reference's `nn.Sequential`), so reference
checkpoints and goldens load with plain `load_state_dict`.

Two departures from `torch.nn`, both inherited from the JAX package:

* `BatchNorm` takes a row mask: padding rows (`Graph.node_mask` False) must
  not enter the batch statistics. `torch.nn.BatchNorm1d` would count them.
* `dropout` draws its mask from an explicit `torch.Generator` and keeps a
  bool mask for the backward (JAX redraws it from the key instead; the two
  frameworks' random streams differ, so parity tests use dropout 0).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


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


class BatchNorm(nn.Module):
    """BatchNorm1d over the rows of [N, C] (eps 1e-5, momentum 0.1, affine)
    that ignores masked rows: one-pass masked moments with count = valid rows,
    biased variance in the normalisation, unbiased in the running variance."""

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
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mu)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mu, var = self.running_mean, self.running_var
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


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


class MLP(nn.Sequential):
    """Lin → norm → ReLU per layer, a bare Lin last when ``last_lin``; child
    indices match the reference `nn.Sequential` (`mlp.0`, `mlp.1`, `mlp.3`).

    Only ReLU and no dropout inside: the configurations this slice runs use
    no other (the reference's prelu/leakyrelu MLPs belong to later slices)."""

    def __init__(self, channels: Sequence[int], norm: Optional[str] = None,
                 bias: bool = True, last_lin: bool = False,
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
            layers.append(nn.ReLU())
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None):
        for layer in self:
            if isinstance(layer, Linear):
                x = layer(x, compute_dtype)
            elif isinstance(layer, nn.ReLU):
                x = layer(x)
            else:
                x = layer(x, mask)
        return x
