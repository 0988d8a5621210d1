"""Process groups and the differentiable collectives of the parallel layer
(the port's counterpart of what JAX's `shard_map` gives implicitly, and of
`deep_gcns_torch_tpu/parallel/mesh.py`).

Set-up (`init_rank`): rendezvous through a `FileStore` in a directory the
caller names (no TCP port), `init_process_group` with a bounded timeout, rank
r on `cuda:(r % device_count)` (set explicitly) or on the CPU when asked. The
backend is NCCL when every rank has a card of its own and gloo otherwise:
NCCL refuses two ranks on one GPU. Under gloo a CUDA tensor goes to the
collective through an explicit copy to host memory and back; the copies are
counted (`STATS["staged_bytes"]`) and logged once a process, naming the
backend.

Collectives, each an autograd Function whose backward is its adjoint. Each
takes an optional ``group`` (a process group from `dist.new_group`, as
`parallel.mesh.make_grid` makes them for a gp × tp grid; None is the
default group); D and a rank's index are then the group's own size and
rank, and a peer's group rank maps back to its global rank through
`dist.get_global_rank`:

* `ppermute(x, shift)`: rank p sends to (p + shift) mod D and receives from
  (p − shift) mod D; the backward is the reverse permute (JAX
  `spatial.py:366-377`);
* `all_gather(x)`: the ranks' rows concatenated in rank order; the backward
  is a reduce-scatter (sum) of the cotangent's rows (`spatial.py:385-388`);
* `psum_scatter(x, dim)`: JAX's tiled `psum_scatter` (`tensor.py:180`): the
  ranks' ``x`` summed and split along ``dim`` in rank order, rank d keeping
  block d; the backward is the tiled all-gather along ``dim``;
* `all_reduce_sum(x)`: the sum of the ranks' ``x``, whose cotangent differs
  from rank to rank (each rank's comes from its own rows or channels, as in
  BatchNorm's cross-rank moments or the tensor-parallel LayerNorm's packed
  moments, `tensor.py:67-78`): the backward is an all-reduce of the
  cotangents;
* `all_reduce_replicated(x)`: the same forward for a sum that every rank
  then consumes identically (Megatron's "g": the tensor-parallel head's
  logits, from which every rank computes the same loss): the cotangent is
  the same on every rank and is passed through as it is. JAX's transpose of
  that `psum` (`tensor.py:311-313`) does the same; an all-reduce there
  would scale every sharded gradient by D;
* `pmax(x)`: no gradient (`spatial.py:449-452` takes it under stop-gradient).

Every rank must issue the same collectives in the same order, the backward
included, or gloo and NCCL wait until the group's timeout. A group of one
rank takes the same calls.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

_LOG = logging.getLogger(__name__)

# counters of this process: bytes copied to host memory and back for gloo,
# and collective calls (a forward or backward call each)
STATS = {"staged_bytes": 0, "calls": 0}
_STATE = {"logged": False}


def reset_stats():
    STATS.update(staged_bytes=0, calls=0)


def rank_device(rank: int, device: str = "cpu") -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)``, set as the
    current device, or the CPU. A CUDA request without a card raises."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def pick_backend(dev: torch.device, world: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, store_dir: str, device: str = "cpu",
              timeout_s: float = 60.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` through a
    `FileStore` in ``store_dir``; returns the rank's device."""
    dev = rank_device(rank, device)
    backend = pick_backend(dev, world)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _STATE["logged"] = False
    reset_stats()
    return dev


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size(group=None) -> int:
    """D of ``group`` (the default group when None; 1 without one)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank_of(group=None) -> int:
    """This rank's index in ``group`` (the default group when None)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def global_rank(group, r: int) -> int:
    """The global rank of ``group``'s rank ``r``."""
    return r if group is None else dist.get_global_rank(group, r)


def _staged(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` goes through host memory: a CUDA tensor under gloo."""
    if not x.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if not _STATE["logged"]:
        _STATE["logged"] = True
        _LOG.warning("parallel.comm: backend gloo, CUDA tensors are staged through host "
                     "memory for every collective (counted in comm.STATS['staged_bytes'])")
    return True


def _host(x: torch.Tensor) -> torch.Tensor:
    STATS["staged_bytes"] += x.numel() * x.element_size()
    return x.cpu()


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    STATS["staged_bytes"] += host.numel() * host.element_size()
    return host.to(like.device)


# torch 2.13 renames `reduce_scatter_tensor` (same arguments)
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _all_reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    """A reduced copy of ``x`` (``x`` is not written)."""
    STATS["calls"] += 1
    if _staged(x, group):
        h = _host(x).clone()
        dist.all_reduce(h, op=op, group=group)
        return _back(h, x)
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    STATS["calls"] += 1
    d = world_size(group)
    src = _host(x) if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(d)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return _back(out, x) if out.device != x.device else out


def _reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` summed, split into D blocks along ``dim``; this
    rank's block. One `reduce_scatter_tensor`, which splits the leading
    axis: another ``dim`` moves its D blocks to the front first."""
    STATS["calls"] += 1
    d = world_size(group)
    if x.shape[dim] % d:
        raise ValueError(f"psum_scatter: {x.shape[dim]} entries along dim {dim} do not split "
                         f"over {d} ranks")
    if dim != 0:
        # [.., D·B, ..] → [D, .., B, ..]: block d of ``dim`` is slab d
        blocks = x.reshape(x.shape[:dim] + (d, x.shape[dim] // d) + x.shape[dim + 1:])
        x_in = blocks.movedim(dim, 0).contiguous()
    else:
        x_in = x.contiguous()
    staged = _staged(x, group)
    src = _host(x_in) if staged else x_in
    # gloo asks output.shape[0] · D == input.shape[0]
    out = torch.empty((src.shape[0] // d,) + src.shape[1:], dtype=src.dtype, device=src.device)
    _reduce_scatter_tensor(out, src, group=group)
    if dim != 0:
        out = out[0]
    return _back(out, x) if staged else out


def _permute(x: torch.Tensor, shift: int, group=None) -> torch.Tensor:
    STATS["calls"] += 1
    d, me = world_size(group), rank_of(group)
    staged = _staged(x, group)
    src = _host(x) if staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, global_rank(group, (me + shift) % d), group=group),
           dist.P2POp(dist.irecv, out, global_rank(group, (me - shift) % d), group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(out, x) if staged else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _permute(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, -ctx.shift, ctx.group), None, None


def ppermute(x: torch.Tensor, shift: int, group=None) -> torch.Tensor:
    """Rank p's ``x`` to rank (p + shift) mod D; returns what rank
    (p − shift) mod D sent. Every rank's ``x`` has the same shape."""
    return _PPermute.apply(x, shift, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, 0), None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[S, ...] on each rank → [D·S, ...], rank d's rows at [d·S, (d+1)·S)."""
    return _AllGather.apply(x, group)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def psum_scatter(x: torch.Tensor, dim: int = 1, group=None) -> torch.Tensor:
    """Σ of the ranks' ``x``, split into D equal blocks along ``dim``: rank
    d's block d (JAX's ``psum_scatter(..., scatter_dimension=dim,
    tiled=True)``). [N, C] → [N, C/D] along the channels."""
    return _PsumScatter.apply(x, dim, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), dist.ReduceOp.SUM, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor); the backward sums the
    ranks' cotangents."""
    return _AllReduceSum.apply(x, group)


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, for an output that every rank consumes
    identically (the cotangent, the same on every rank, passes through)."""
    return _AllReduceReplicated.apply(x, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum over the ranks, without gradient."""
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, group)


def all_reduce_grads(params, scale: Optional[float] = None, group=None):
    """Sum every parameter's gradient over the ranks (one flat collective),
    then multiply by ``scale`` when given. Ranks must pass the same
    parameters in the same order; a missing gradient counts as 0."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    flat = _all_reduce(flat, dist.ReduceOp.SUM, group)
    if scale is not None:
        flat = flat * scale
    off = 0
    for p in params:
        n = p.numel()
        g = flat[off:off + n].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        off += n


def cross_rank_moments(mu: torch.Tensor, var: torch.Tensor, cnt: torch.Tensor, group=None):
    """JAX's cross-replica BatchNorm moments (`nn/core.py:285-290`): E[x] and
    E[x²] = var + E[x]² averaged over the ranks of ``group`` with equal
    weight, the variance E[x²] − E[x]², and the ranks' counts summed. The
    equal weights assume equal per-rank counts (a quirk the port keeps). A
    group of one returns the moments as they are."""
    d = world_size(group)
    if d == 1:
        return mu, var, cnt
    c = mu.shape[0]
    packed = torch.cat([mu, var + mu * mu, cnt.reshape(1).to(mu.dtype).detach()])
    tot = all_reduce_sum(packed, group)
    mu = tot[:c] / d
    ex2 = tot[c:2 * c] / d
    return mu, ex2 - mu * mu, tot[2 * c].detach()
