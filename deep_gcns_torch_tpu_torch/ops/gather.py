"""Row gathers by sender or receiver whose backward is a CSR segment sum on
K1 (counterpart of `deep_gcns_torch_tpu/ops/gather.py:24-98`).

The backward of ``x[senders]`` is a scatter-add over unsorted sender ids.
With the graph's CSC auxiliaries it becomes one segment sum over the
sender-sorted edge ranges, in K1's gathered form: out[s] = Σ g[csc_perm[e]]
over s's CSC range, so the cotangent is never permuted into a second [E, C]
array. The receiver gather needs no permutation at all (edges are sorted by
receiver). Both sums are deterministic, and sentinel edges are never read.

`gather_neighbors` is the dense point-cloud gather x [B, N, C], idx [B, N,
K] → [B, N, K, C] (JAX `ops/gather.py:100-152`): its backward sorts the flat
batch-offset neighbour ids by sender (`neighbor_transpose`) and sums the
cotangent over each point's sender range through K1's gathered form.
"""

from __future__ import annotations

import torch

from .segment import sum_k1_ok_shape
from .spmm_cuda import csr_seg_sum


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] with the sentinel ids clamped to the last row."""
    return x.index_select(0, torch.clamp(ids.long(), max=x.shape[0] - 1))


class _GatherSrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, csc_perm, csc_col_ptr):
        ctx.save_for_backward(csc_perm, csc_col_ptr)
        return _take(x, senders)

    @staticmethod
    def backward(ctx, g):
        csc_perm, csc_col_ptr = ctx.saved_tensors
        return csr_seg_sum(g.contiguous(), csc_col_ptr, csc_perm), None, None, None


def gather_src(x: torch.Tensor, senders: torch.Tensor, csc_perm: torch.Tensor,
               csc_col_ptr: torch.Tensor) -> torch.Tensor:
    """x[senders] (sentinels clamped); the backward sums the cotangent over
    each sender's CSC range through K1 (the ranges of ``csc_col_ptr`` give
    each edge's sender, so the JAX package's ``csc_senders`` is not needed)."""
    return _GatherSrc.apply(x, senders, csc_perm, csc_col_ptr)


def gather_src_auto(x: torch.Tensor, g) -> torch.Tensor:
    """`gather_src` when the graph carries its CSC auxiliaries, else a plain
    index_select (whose backward is torch's scatter-add)."""
    if g.csc_perm is not None and g.csc_col_ptr is not None:
        return gather_src(x, g.senders, g.csc_perm, g.csc_col_ptr)
    return _take(x, g.senders)


class _GatherDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, receivers, row_ptr):
        ctx.save_for_backward(row_ptr)
        return _take(x, receivers)

    @staticmethod
    def backward(ctx, g):
        (row_ptr,) = ctx.saved_tensors
        return csr_seg_sum(g.contiguous(), row_ptr), None, None


def gather_dst(x: torch.Tensor, receivers: torch.Tensor, row_ptr: torch.Tensor
               ) -> torch.Tensor:
    """x[receivers] (sentinels clamped); receivers are sorted, so the
    backward is K1 over the CSR ranges of the cotangent directly."""
    return _GatherDst.apply(x, receivers, row_ptr)


def gather_dst_auto(x: torch.Tensor, g) -> torch.Tensor:
    """`gather_dst` when the graph has its CSR ``row_ptr``, else a plain
    index_select."""
    if g.row_ptr is not None:
        return gather_dst(x, g.receivers, g.row_ptr)
    return _take(x, g.receivers)


def _flat_ids(idx: torch.Tensor) -> torch.Tensor:
    """idx [B, N, K] → the batch-offset ids [B·N·K] into x.reshape(B·N, C)."""
    b, n, _ = idx.shape
    offs = (torch.arange(b, dtype=idx.dtype, device=idx.device) * n)[:, None, None]
    return (idx + offs).reshape(-1)


def neighbor_transpose(idx: torch.Tensor):
    """The sender-sorted transpose of a dense kNN edge list: idx [B, N, K] →
    int32 (csc_perm [E], csc_senders [E], csc_row_ptr [B·N + 1]), E = B·N·K,
    by a stable sort of the flat ids (JAX's `sort_key_val`, also stable), so
    a sender's edges keep their flat order."""
    b, n, _ = idx.shape
    senders, perm = torch.sort(_flat_ids(idx).int(), stable=True)
    grid = torch.arange(b * n + 1, dtype=torch.int32, device=idx.device)
    row_ptr = torch.searchsorted(senders, grid, out_int32=True)
    return perm.int(), senders, row_ptr


class _GatherNeighbors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        b, n, c = x.shape
        ctx.save_for_backward(idx)
        ctx.shape = (b, n, c)
        flat = x.reshape(b * n, c).index_select(0, _flat_ids(idx))
        return flat.reshape(idx.shape + (c,))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, n, c = ctx.shape
        perm, _, row_ptr = neighbor_transpose(idx)
        dx = csr_seg_sum(g.reshape(-1, c).contiguous(), row_ptr, perm)
        return dx.reshape(b, n, c), None


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, N, K] → [B, N, K, C]. At a width that passes
    `sum_k1_ok_shape` (C ≥ 32) the backward is K1's gathered form over the
    sender-sorted transpose, built in the backward; narrower rows take a
    plain index_select, whose backward is torch's scatter-add (the JAX
    package's gate, without its platform and tile clauses)."""
    b, n, k = idx.shape
    c = x.shape[-1]
    if sum_k1_ok_shape((b * n * k, c)):
        return _GatherNeighbors.apply(x, idx)
    flat = x.reshape(b * n, c).index_select(0, _flat_ids(idx))
    return flat.reshape(b, n, k, c)
