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

Collectives, each an autograd Function whose backward is its adjoint:

* `ppermute(x, shift)`: rank p sends to (p + shift) mod D and receives from
  (p − shift) mod D; the backward is the reverse permute (JAX
  `spatial.py:366-377`);
* `all_gather(x)`: the ranks' rows concatenated in rank order; the backward
  is a reduce-scatter (sum), here an all-reduce of the cotangent and this
  rank's slice of it, which every backend and version takes
  (`spatial.py:385-388`);
* `all_reduce_sum(x)`: the backward is an all-reduce of the cotangents;
* `pmax(x)`: no gradient (`spatial.py:449-452` takes it under stop-gradient).

Every rank must issue the same collectives in the same order, the backward
included, or gloo and NCCL wait until the group's timeout.
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


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_of() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _staged(x: torch.Tensor) -> bool:
    """Whether ``x`` goes through host memory: a CUDA tensor under gloo."""
    if not x.is_cuda or dist.get_backend() != "gloo":
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


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """A reduced copy of ``x`` (``x`` is not written)."""
    STATS["calls"] += 1
    if _staged(x):
        h = _host(x).clone()
        dist.all_reduce(h, op=op)
        return _back(h, x)
    y = x.clone()
    dist.all_reduce(y, op=op)
    return y


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    STATS["calls"] += 1
    d = world_size()
    src = _host(x) if _staged(x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(d)]
    dist.all_gather(parts, src)
    out = torch.cat(parts, 0)
    return _back(out, x) if out.device != x.device else out


def _permute(x: torch.Tensor, shift: int) -> torch.Tensor:
    STATS["calls"] += 1
    d, me = world_size(), rank_of()
    staged = _staged(x)
    src = _host(x) if staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, (me + shift) % d),
           dist.P2POp(dist.irecv, out, (me - shift) % d)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(out, x) if staged else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift):
        ctx.shift = shift
        return _permute(x, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, -ctx.shift), None


def ppermute(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Rank p's ``x`` to rank (p + shift) mod D; returns what rank
    (p − shift) mod D sent. Every rank's ``x`` has the same shape."""
    return _PPermute.apply(x, shift)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _all_gather(x)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g.contiguous(), dist.ReduceOp.SUM)
        me = rank_of()
        return total[me * ctx.rows:(me + 1) * ctx.rows].contiguous()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[S, ...] on each rank → [D·S, ...], rank d's rows at [d·S, (d+1)·S)."""
    return _AllGather.apply(x)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), dist.ReduceOp.SUM)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor)."""
    return _AllReduceSum.apply(x)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks, without gradient."""
    return _all_reduce(x.detach(), dist.ReduceOp.MAX)


def all_reduce_grads(params, scale: Optional[float] = None):
    """Sum every parameter's gradient over the ranks (one flat collective),
    then multiply by ``scale`` when given. Ranks must pass the same
    parameters in the same order; a missing gradient counts as 0."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    flat = _all_reduce(flat, dist.ReduceOp.SUM)
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


def cross_rank_moments(mu: torch.Tensor, var: torch.Tensor, cnt: torch.Tensor):
    """JAX's cross-replica BatchNorm moments (`nn/core.py:285-290`): E[x] and
    E[x²] = var + E[x]² averaged over the ranks with equal weight, the
    variance E[x²] − E[x]², and the ranks' counts summed. The equal weights
    assume equal per-rank counts (a quirk the port keeps). A world of one
    returns the moments as they are."""
    d = world_size()
    if d == 1:
        return mu, var, cnt
    c = mu.shape[0]
    packed = torch.cat([mu, var + mu * mu, cnt.reshape(1).to(mu.dtype).detach()])
    tot = all_reduce_sum(packed)
    mu = tot[:c] / d
    ex2 = tot[c:2 * c] / d
    return mu, ex2 - mu * mu, tot[2 * c].detach()
