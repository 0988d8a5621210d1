"""The dense (batched point-cloud) graph convs, channels-last [B, N, K, C]
(counterpart of `deep_gcns_torch_tpu/convs/dense.py:30-345`, reference
`gcn_lib/dense/`):

* `BasicConv`: per stage a 1×1 conv, which on channels-last data is a
  matmul over C (not a cuDNN convolution), then act, norm and dropout;
  kaiming-normal weights, zero biases;
* `BatchNorm2d` over every (B, N, K) position, `InstanceNorm2d` per (batch,
  channel) over (N, K);
* `EdgeConv2d` max_k BasicConv([x_i ‖ x_j − x_i]), `MRConv2d`
  BasicConv([x ‖ max_k(x_j − x_i)]), `DynConv2d` on a dilated kNN graph
  built per forward, and the plain / res / dense blocks.

The neighbour features come from `ops.gather.gather_neighbors`, whose
backward is K1 at 32 channels or more; x_i is a broadcast (the centres are
the canonical arange), so its backward is a sum over k. The maxima over k
split their gradient evenly over ties (`torch.amax`), as JAX's `jnp.max`
does: ties are common after `BasicConv`, whose norm follows the activation.

Parameter names are the reference's (`gconv.nn.0.weight` [out, in, 1, 1],
`nn.2.running_var`, `body.gconv...`), so its `state_dict`s load by name.
``compute_dtype`` "bfloat16" rounds x before the gather and runs the
products in bf16 with float32 accumulation.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.core import _MatmulF32, _STATS, act_layer, dropout
from ..ops.gather import gather_neighbors
from ..ops.knn import dilated_knn_graph_dense
from .sparse import _dtype


def batched_index_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, N, K] → [B, N, K, C] by a plain index_select
    (`torch_nn.py:75-96`)."""
    b, n, k = idx.shape
    offs = (torch.arange(b, device=idx.device) * n)[:, None, None]
    flat = x.reshape(b * n, -1).index_select(0, (idx.long() + offs).reshape(-1))
    return flat.reshape(b, n, k, -1)


def _check_canonical_centers(centers: Optional[torch.Tensor]) -> None:
    """EdgeConv2d and MRConv2d broadcast x_i instead of gathering it, so an
    explicitly passed centre array must be the canonical arange. The check
    reads it on the host; the models and `DynConv2d` pass None, so the
    per-layer path never syncs."""
    if centers is None:
        return
    c = centers.detach().cpu()
    want = torch.arange(c.shape[-2], dtype=c.dtype)[:, None]
    if not bool((c == want).all()):
        raise ValueError(
            "EdgeConv2d/MRConv2d require canonical centers (broadcast arange(N)); "
            "got a non-canonical center index array. Gather the features with "
            "batched_index_select yourself or reorder the edge_index.")


class BatchNorm2d(nn.Module):
    """BatchNorm over every position of channels-last x [..., C] (torch's
    BatchNorm2d on B×C×N×K): the two-pass biased variance normalises; the
    running variance takes var·cnt/(cnt − 1), cnt the positions, at
    momentum 0.1 (`convs/dense.py:71-90`)."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            red = tuple(range(x.ndim - 1))
            mu = x.mean(red)
            var = torch.square(x - mu).mean(red)
            if not getattr(_STATS, "frozen", False):
                self._update_running(mu, var, x.numel() / x.shape[-1])
        else:
            mu, var = self.running_mean, self.running_var
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias

    @torch.no_grad()
    def _update_running(self, mu, var, cnt: float):
        unbiased = var * cnt / max(cnt - 1.0, 1.0)
        self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mu)
        self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        self.num_batches_tracked.add_(1)


class InstanceNorm2d(nn.Module):
    """Non-affine normalisation per (batch, channel) over the spatial axes."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        red = tuple(range(1, x.ndim - 1))
        mu = x.mean(red, keepdim=True)
        var = torch.square(x - mu).mean(red, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps)


def make_norm2d(norm: Optional[str], dim: int) -> Optional[nn.Module]:
    if norm is None or str(norm).lower() == "none":
        return None
    n = norm.lower()
    if n == "batch":
        return BatchNorm2d(dim)
    if n == "instance":
        return InstanceNorm2d(dim)
    raise NotImplementedError(f"normalization layer [{norm}] is not found")


class Conv1x1(nn.Module):
    """The reference's 1×1 `Conv2d` under its names (`weight` [out, in, 1, 1],
    `bias`), applied as a matmul over the last axis; kaiming-normal weight
    (std √(2/in)), zero bias."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = torch.randn((cout, cin), generator=generator) * math.sqrt(2.0 / cin)
        self.weight = nn.Parameter(w[:, :, None, None])
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        w = self.weight[:, :, 0, 0]
        if compute_dtype is not None:
            lead = x.shape[:-1]
            y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]).to(compute_dtype),
                                 w.to(compute_dtype).t())
            y = y.reshape(lead + (w.shape[0],))
        else:
            y = torch.nn.functional.linear(x, w)
        return y if self.bias is None else y + self.bias


class _Dropout(nn.Module):
    """The slot of the reference's `Dropout2d`; the port drops elements from
    an explicit generator, as the JAX package does."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate


class BasicConv(nn.Sequential):
    """Stages of conv → act → norm → dropout (reference `BasicConv`,
    `torch_nn.py:48-72`; child indices as its `Seq`)."""

    def __init__(self, channels: Sequence[int], act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True, drop: float = 0.0,
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        layers = []
        for i in range(1, len(channels)):
            layers.append(Conv1x1(channels[i - 1], channels[i], bias, generator))
            a = act_layer(act)
            if a is not None:
                layers.append(a)
            nrm = make_norm2d(norm, channels[i])
            if nrm is not None:
                layers.append(nrm)
            if drop > 0:
                layers.append(_Dropout(drop))
        super().__init__(*layers)
        self.compute_dtype = _dtype(compute_dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        for layer in self:
            if isinstance(layer, Conv1x1):
                x = layer(x, self.compute_dtype)
            elif isinstance(layer, _Dropout):
                x = dropout(x, layer.rate, train=self.training, generator=generator)
            else:
                x = layer(x)
        return x


EdgeIndex = Tuple[torch.Tensor, Optional[torch.Tensor]]


class EdgeConv2d(nn.Module):
    """max_k BasicConv([x_i ‖ x_j − x_i]) (`torch_vertex.py:23-35`); the
    edge index is (neighbour ids [B, N, K], centres or None)."""

    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True,
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = _dtype(compute_dtype)
        self.nn = BasicConv([in_dim * 2, out_dim], act, norm, bias,
                            compute_dtype=compute_dtype, generator=generator)

    def forward(self, x: torch.Tensor, edge_index: EdgeIndex,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        nn_idx, centers = edge_index
        _check_canonical_centers(centers)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)  # before the gather: half the traffic
        x_j = gather_neighbors(x, nn_idx)
        x_i = x[:, :, None, :].expand_as(x_j)
        y = self.nn(torch.cat([x_i, x_j - x_i], -1), generator)
        return torch.amax(y, 2)


class MRConv2d(nn.Module):
    """BasicConv([x ‖ max_k(x_j − x_i)]) (`torch_vertex.py:8-20`)."""

    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True,
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = _dtype(compute_dtype)
        self.nn = BasicConv([in_dim * 2, out_dim], act, norm, bias,
                            compute_dtype=compute_dtype, generator=generator)

    def forward(self, x: torch.Tensor, edge_index: EdgeIndex,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        nn_idx, centers = edge_index
        _check_canonical_centers(centers)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        rel = torch.amax(gather_neighbors(x, nn_idx) - x[:, :, None, :], 2)
        y = self.nn(torch.cat([x, rel], -1)[:, :, None, :], generator)
        return y[:, :, 0, :]


def graph_conv2d(in_dim: int, out_dim: int, conv: str = "edge", act: Optional[str] = "relu",
                 norm: Optional[str] = None, bias: bool = True,
                 compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    if conv == "edge":
        return EdgeConv2d(in_dim, out_dim, act, norm, bias, compute_dtype, generator)
    if conv == "mr":
        return MRConv2d(in_dim, out_dim, act, norm, bias, compute_dtype, generator)
    raise NotImplementedError(f"conv:{conv} is not supported")


class GraphConv2d(nn.Module):
    """The reference's `GraphConv2d`: the conv at `gconv`."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.gconv = graph_conv2d(*args, **kwargs)

    def forward(self, x: torch.Tensor, edge_index: EdgeIndex,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.gconv(x, edge_index, generator)


class DynConv2d(GraphConv2d):
    """A graph conv on the dilated kNN graph of its input, built per forward
    (`torch_vertex.py:55-72`); kNN draws its stochastic choices from the
    forward's generator in training mode."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 9, dilation: int = 1,
                 conv: str = "edge", act: Optional[str] = "relu", norm: Optional[str] = None,
                 bias: bool = True, stochastic: bool = False, epsilon: float = 0.0,
                 knn_method: str = "exact", compute_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, conv, act, norm, bias, compute_dtype, generator)
        self.k, self.dilation = kernel_size, dilation
        self.stochastic, self.epsilon, self.knn_method = stochastic, epsilon, knn_method

    def forward(self, x: torch.Tensor, edge_index: Optional[EdgeIndex] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if edge_index is None:
            nn_idx, _ = dilated_knn_graph_dense(
                x, self.k, self.dilation, stochastic=self.stochastic, epsilon=self.epsilon,
                train=self.training, generator=generator, method=self.knn_method)
            edge_index = (nn_idx, None)
        return self.gconv(x, edge_index, generator)


class _Block2d(nn.Module):
    """plain / res / dense wrapper of a `DynConv2d` at `body`
    (`torch_vertex.py:75-116`): res y + res_scale·x, dense [x ‖ y]."""

    def __init__(self, body: DynConv2d, kind: str, res_scale: float = 1.0):
        super().__init__()
        self.body, self.kind, self.res_scale = body, kind, res_scale

    def forward(self, x: torch.Tensor, edge_index: Optional[EdgeIndex] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.body(x, edge_index, generator)
        if self.kind == "res":
            return y + x * self.res_scale
        if self.kind == "dense":
            return torch.cat([x, y], -1)
        return y


def PlainDynBlock2d(in_channels, kernel_size=9, dilation=1, conv="edge", act="relu",
                    norm=None, bias=True, stochastic=False, epsilon=0.0, knn_method="exact",
                    compute_dtype=None, generator=None) -> _Block2d:
    return _Block2d(DynConv2d(in_channels, in_channels, kernel_size, dilation, conv, act, norm,
                              bias, stochastic, epsilon, knn_method, compute_dtype, generator),
                    "plain")


def ResDynBlock2d(in_channels, kernel_size=9, dilation=1, conv="edge", act="relu", norm=None,
                  bias=True, stochastic=False, epsilon=0.0, res_scale=1.0, knn_method="exact",
                  compute_dtype=None, generator=None) -> _Block2d:
    return _Block2d(DynConv2d(in_channels, in_channels, kernel_size, dilation, conv, act, norm,
                              bias, stochastic, epsilon, knn_method, compute_dtype, generator),
                    "res", res_scale)


def DenseDynBlock2d(in_channels, out_channels=64, kernel_size=9, dilation=1, conv="edge",
                    act="relu", norm=None, bias=True, stochastic=False, epsilon=0.0,
                    knn_method="exact", compute_dtype=None, generator=None) -> _Block2d:
    return _Block2d(DynConv2d(in_channels, out_channels, kernel_size, dilation, conv, act, norm,
                              bias, stochastic, epsilon, knn_method, compute_dtype, generator),
                    "dense")
