"""Row gathers by sender or receiver whose backward is a CSR segment sum on
K1 (counterpart of `deep_gcns_torch_tpu/ops/gather.py:24-98`).

The backward of ``x[senders]`` is a scatter-add over unsorted sender ids.
With the graph's CSC auxiliaries it becomes one segment sum over the
sender-sorted edge ranges, in K1's gathered form: out[s] = Σ g[csc_perm[e]]
over s's CSC range, so the cotangent is never permuted into a second [E, C]
array. The receiver gather needs no permutation at all (edges are sorted by
receiver). Both sums are deterministic, and sentinel edges are never read.

`gather_neighbors` (the dense point-cloud gather) comes with the point-cloud
slice and raises until then.
"""

from __future__ import annotations

import torch

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


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The dense [B, N, K] neighbour gather of the point-cloud models is not
    ported yet."""
    raise NotImplementedError("gather_neighbors comes with the point-cloud slice")
