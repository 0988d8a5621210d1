"""Segment reductions with the reference's torch_scatter semantics
(counterpart of `deep_gcns_torch_tpu/ops/segment.py:40-370`).

* Out-of-range segment ids (the ``N_pad`` sentinel of padded edges) and
  masked entries contribute nothing.
* Empty segments give 0 for sum/mean and for max/min.
* The max/min backward splits the gradient evenly over exact ties.
* `generalized_aggregate` is DeeperGCN's SoftMax/PowerMean family with the
  reference's stop-gradient softmax weights unless ``learn_t`` (for softmax
  and softmax_sum), the power clamps to [1e-7, 10] and the degree scaling
  of the ``*_sum`` variants.

The kernel routes, taken as the JAX package takes them on a TPU, minus its
platform clause (a CPU tensor runs each kernel's plain version) and its
tile-alignment clauses (the port's kernels take any padding):

* `segment_sum`, `segment_mean` and `scatter` given the receivers' CSR
  ``row_ptr`` sum through K1 (`spmm_cuda.segment_sum_csr`) when the flat
  width is at least 32 (JAX's `sum_pallas_ok_shape`);
* `generalized_aggregate` given ``row_ptr`` sums add/sum and mean through
  K1 and runs the softmax family through K2's message form
  (`spmm_cuda.gen_softmax_aggregate_csr`).

A route that a missing ``row_ptr`` (or, for GENConv's fused route, CSC)
turns away is counted in the ledger of `route_misses` (read with
`fastpath_misses()`, which this module re-exports as the JAX package's does),
and logged once per reason when the tensors are on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .route_misses import fastpath_misses, miss  # noqa: F401
from .spmm_cuda import gen_softmax_aggregate_csr, segment_sum_csr

Scalar = Union[torch.Tensor, float]


def sum_k1_ok_shape(shape) -> bool:
    """The gate of a segment sum's K1 route, given ``row_ptr``
    (`sum_pallas_ok_shape` of the JAX package, `ops/segment.py:81-105`,
    without its platform clause, its lane-padding clause, which refuses no
    width of 32 or more, and its E_pad % 512 and N_pad % 128 clause: K1
    reads CSR ranges, not tiles): a flat width of at least 32. Narrower
    rows, and a sum without ``row_ptr`` (a degree, a sum over another
    index), take the scatter path and are no miss."""
    c = 1
    for d in shape[1:]:
        c *= d
    return c >= 32


def _valid(segment_ids: torch.Tensor, num_segments: int,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    ok = segment_ids < num_segments
    return ok if mask is None else ok & mask


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None,
                row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ data over each segment. Given the sorted ids' CSR ``row_ptr`` and a
    flat width that passes `sum_k1_ok_shape`, the masked data is summed over
    each CSR range by K1 (entries past ``row_ptr[-1]`` are not read)."""
    if row_ptr is not None and sum_k1_ok_shape(data.shape):
        if mask is not None:
            data = torch.where(_bcast(mask, data), data,
                               torch.zeros((), dtype=data.dtype, device=data.device))
        flat = data.reshape(data.shape[0], -1)
        out = segment_sum_csr(flat.contiguous(), segment_ids, row_ptr)
        return out.reshape((num_segments,) + data.shape[1:])
    ok = _valid(segment_ids, num_segments, mask)
    data = torch.where(_bcast(ok, data), data, torch.zeros((), dtype=data.dtype,
                                                            device=data.device))
    ids = torch.clamp(segment_ids.long(), max=num_segments - 1)
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids, data)


def segment_degree(segment_ids: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Number of valid entries per segment (PyG `degree`)."""
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 mask: Optional[torch.Tensor] = None,
                 row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments, mask, row_ptr)
    cnt = segment_degree(segment_ids, num_segments, mask, s.dtype)
    return s / _bcast(torch.clamp_min(cnt, 1), s)


class _SegmentExtreme(torch.autograd.Function):
    """Segment max/min whose backward routes the cotangent to the entries
    equal to their segment's extreme, split evenly among exact ties."""

    @staticmethod
    def forward(ctx, data, segment_ids, mask, num_segments, kind):
        fill = float("-inf") if kind == "max" else float("inf")
        ok = _bcast(_valid(segment_ids, num_segments, mask), data)
        filled = torch.where(ok, data, torch.full((), fill, dtype=data.dtype,
                                                   device=data.device))
        ids = torch.clamp(segment_ids.long(), max=num_segments - 1)
        idx = _bcast(ids, data).expand_as(data)
        out = torch.full((num_segments,) + data.shape[1:], fill, dtype=data.dtype,
                         device=data.device)
        out = out.scatter_reduce(0, idx, filled, "amax" if kind == "max" else "amin",
                                 include_self=True)
        out = torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                                 device=out.device))
        ctx.save_for_backward(filled, ids, ok, out)
        ctx.num_segments = num_segments
        return out

    @staticmethod
    def backward(ctx, g):
        filled, ids, ok, out = ctx.saved_tensors
        out_e = out.index_select(0, ids)
        elig = (filled == out_e) & torch.isfinite(filled) & ok
        cnt = segment_sum(elig.float(), ids, ctx.num_segments)
        cnt_e = torch.clamp_min(cnt, 1.0).index_select(0, ids)
        g_e = g.float().index_select(0, ids)
        dd = torch.where(elig, g_e / cnt_e, torch.zeros((), device=g.device))
        return dd.to(filled.dtype), None, None, None, None


def segment_max(data, segment_ids, num_segments, mask=None):
    return _SegmentExtreme.apply(data, segment_ids, mask, num_segments, "max")


def segment_min(data, segment_ids, num_segments, mask=None):
    return _SegmentExtreme.apply(data, segment_ids, mask, num_segments, "min")


def scatter(name: str, data: torch.Tensor, segment_ids: torch.Tensor,
            num_segments: int, mask: Optional[torch.Tensor] = None,
            row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Named dispatch (reference `scatter_`); sum and mean take ``row_ptr``
    (the K1 route of `segment_sum`), max and min do not read it."""
    if name in ("add", "sum", "mean"):
        fn = segment_mean if name == "mean" else segment_sum
        return fn(data, segment_ids, num_segments, mask, row_ptr)
    fns = {"max": segment_max, "min": segment_min}
    return fns[name](data, segment_ids, num_segments, mask)


def segment_softmax(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-(segment, channel) softmax weights over entries, stabilised by the
    per-segment max (torch_scatter.scatter_softmax); masked entries get 0."""
    ok = _bcast(_valid(segment_ids, num_segments, mask), data)
    ids = torch.clamp(segment_ids.long(), max=num_segments - 1)
    with torch.no_grad():
        logits = torch.where(ok, data, torch.full((), float("-inf"), dtype=data.dtype,
                                                   device=data.device))
        seg_max = torch.full((num_segments,) + data.shape[1:], float("-inf"),
                             dtype=data.dtype, device=data.device)
        seg_max = seg_max.scatter_reduce(0, _bcast(ids, data).expand_as(data), logits,
                                         "amax", include_self=True)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              torch.zeros((), dtype=data.dtype, device=data.device))
    e = torch.exp(data - seg_max.index_select(0, ids))
    e = torch.where(ok, e, torch.zeros((), dtype=e.dtype, device=e.device))
    denom = segment_sum(e, segment_ids, num_segments)
    denom = torch.clamp_min(denom, torch.finfo(e.dtype).tiny)
    return e / denom.index_select(0, ids)


KERNEL_AGGRS = ("softmax", "softmax_sg", "softmax_sum", "add", "sum", "mean")


def fused_gather_ok(g, aggr: str) -> bool:
    """GENConv's fused gather + softmax aggregation (K2 forward, K4
    backward) reads the graph's CSR ``row_ptr`` and its CSC ``csc_col_ptr``
    and ``csc_receivers``, with each pointer array's ``row_order`` and
    ``csc_order``: the gate of JAX's `fused_gather_ok`
    (`ops/segment.py:269-294`) without its platform clause, its tile
    alignment and its lane-padding clause (the port's kernels read CSR and
    CSC ranges at any padding and width)."""
    if aggr not in ("softmax", "softmax_sg", "softmax_sum"):
        return False  # the fused pair covers the softmax family only: not a miss
    if any(a is None for a in (g.row_ptr, g.row_order, g.csc_col_ptr, g.csc_order,
                               g.csc_receivers)):
        return miss("fused_gather_agg", "graph lacks CSR/CSC aux indices",
                    warn=g.senders.is_cuda)
    return True


def _kernel_route_ok(aggr: str, row_ptr, msgs: torch.Tensor) -> bool:
    """`generalized_aggregate`'s kernel route (JAX's `_pallas_ok`,
    `ops/segment.py:232-249`, without its platform clause and its tile
    alignment): an aggregator with a kernel and ``row_ptr`` present."""
    if aggr not in KERNEL_AGGRS:
        return False  # no kernel covers this aggregator: not a miss
    if row_ptr is None:
        return miss("generalized_aggregate", "graph has no CSR row_ptr aux",
                    warn=msgs.is_cuda)
    return True


def _deg_scale(out, segment_ids, num_segments, mask, y):
    deg = segment_degree(segment_ids, num_segments, mask, out.dtype)
    return torch.pow(deg, torch.sigmoid(torch.as_tensor(y)))[:, None] * out


def generalized_aggregate(
    msgs: torch.Tensor,
    receivers: torch.Tensor,
    num_segments: int,
    *,
    aggr: str = "softmax",
    t: Scalar = 1.0,
    p: Scalar = 1.0,
    y: Scalar = 0.0,
    learn_t: bool = False,
    mask: Optional[torch.Tensor] = None,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DeeperGCN generalized aggregation over receiver-keyed messages.

    aggr ∈ {softmax, softmax_sg, softmax_sum, power, power_sum, add/sum,
    mean, max, min}. With ``row_ptr`` (the receivers' CSR over the
    receiver-sorted messages), add/sum is K1's segment sum, mean that sum
    over the clamped degree, and the softmax family K2's message form
    (`gen_softmax_aggregate_csr`, the weights differentiated when
    ``learn_t`` for softmax and softmax_sum), as the JAX package routes them
    (`deep_gcns_torch_tpu/ops/segment.py:318-341`): each CSR range is
    aggregated and ``mask`` is not read there, so it may mark only the
    sentinel padding beyond ``row_ptr[-1]``, as a graph's edge mask does."""
    if _kernel_route_ok(aggr, row_ptr, msgs):
        if aggr in ("add", "sum", "mean"):
            s = segment_sum_csr(msgs, receivers, row_ptr)
            if aggr == "mean":
                cnt = segment_degree(receivers, num_segments, mask, s.dtype)
                s = s / torch.clamp_min(cnt, 1)[:, None]
            return s
        grad_w = learn_t and aggr in ("softmax", "softmax_sum")
        out = gen_softmax_aggregate_csr(msgs, receivers, row_ptr, t, grad_w)
        if aggr == "softmax_sum":
            # JAX counts the degree in the output's dtype and scales in float32
            deg = segment_degree(receivers, num_segments, mask, out.dtype).float()
            out = torch.pow(deg, torch.sigmoid(torch.as_tensor(y)))[:, None] * out.float()
        return out
    if aggr in ("add", "sum"):
        return segment_sum(msgs, receivers, num_segments, mask)
    if aggr == "mean":
        return segment_mean(msgs, receivers, num_segments, mask)
    if aggr == "max":
        return segment_max(msgs, receivers, num_segments, mask)
    if aggr == "min":
        return segment_min(msgs, receivers, num_segments, mask)

    if aggr in ("softmax", "softmax_sg", "softmax_sum"):
        w = segment_softmax(msgs * t, receivers, num_segments, mask)
        if not (learn_t and aggr in ("softmax", "softmax_sum")):
            w = w.detach()
        out = segment_sum(msgs * w, receivers, num_segments, mask)
        if aggr == "softmax_sum":
            out = _deg_scale(out, receivers, num_segments, mask, y)
        return out

    if aggr in ("power", "power_sum"):
        lo, hi = 1e-7, 1e1
        m = torch.clamp(msgs, lo, hi)
        out = segment_mean(torch.pow(m, p), receivers, num_segments, mask)
        out = torch.pow(torch.clamp(out, lo, hi), 1.0 / p)
        if aggr == "power_sum":
            out = _deg_scale(out, receivers, num_segments, mask, y)
        return out

    raise NotImplementedError(f"aggregation '{aggr}' is not implemented")


def _segment_max_filled(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-segment maximum with −inf for empty segments (JAX's raw
    `jax.ops.segment_max`), out-of-range ids and masked entries dropped; no
    gradient."""
    ok = _bcast(_valid(segment_ids, num_segments, mask), data)
    ids = torch.clamp(segment_ids.long(), max=num_segments - 1)
    neg = torch.full((), float("-inf"), dtype=data.dtype, device=data.device)
    out = torch.full((num_segments,) + data.shape[1:], float("-inf"), dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, _bcast(ids, data).expand_as(data),
                              torch.where(ok, data.detach(), neg), "amax", include_self=True)


def generalized_aggregate_split(parts, num_segments: int, *, aggr: str = "softmax",
                                t: Scalar = 1.0, p: Scalar = 1.0, y: Scalar = 0.0,
                                learn_t: bool = False) -> torch.Tensor:
    """`generalized_aggregate` over a union of edge sets, each aggregated
    partially and combined exactly (JAX `ops/segment.py:376-492`): the
    spatial layer aggregates the local edges and the halo edges apart.
    ``parts`` is a sequence of (msgs [E_i, C], receivers [E_i], row_ptr or
    None, mask or None), each receiver-sorted. Every part's sums go through
    `segment_sum(..., row_ptr=)`, so K1 runs on each part when it carries
    its CSR. The combine:

    * sum, mean, power: partial sums and counts are linear;
    * max, min: the partial extremes keep ±inf for empty segments until the
      combine, then an empty segment is 0;
    * softmax family: one stop-gradient stabilizer per (segment, channel),
      the max of the partial maxima, makes the partial num/den sums exact;
      the weights are stop-gradient unless ``learn_t`` (softmax,
      softmax_sum), as in `generalized_aggregate`."""
    parts = list(parts)
    if len(parts) == 1:
        m, r, rp, mk = parts[0]
        return generalized_aggregate(m, r, num_segments, aggr=aggr, t=t, p=p, y=y,
                                     learn_t=learn_t, mask=mk, row_ptr=rp)
    n = num_segments

    def deg(dtype):
        return sum(segment_degree(r, n, mk, dtype) for (_, r, _, mk) in parts)

    def sums(vals):
        return sum(segment_sum(v, r, n, mk, row_ptr=rp)
                   for v, (_, r, rp, mk) in zip(vals, parts))

    if aggr in ("add", "sum"):
        return sums([m for (m, _, _, _) in parts])
    if aggr == "mean":
        s = sums([m for (m, _, _, _) in parts])
        return s / _bcast(torch.clamp_min(deg(s.dtype), 1), s)
    if aggr in ("max", "min"):
        fn = segment_max if aggr == "max" else segment_min
        combine = torch.maximum if aggr == "max" else torch.minimum
        fill = float("-inf") if aggr == "max" else float("inf")
        out = any_has = None
        for (m, r, _, mk) in parts:
            o = fn(m, r, n, mk)
            has = _bcast(segment_degree(r, n, mk) > 0, o)
            o = torch.where(has, o, torch.full((), fill, dtype=o.dtype, device=o.device))
            out = o if out is None else combine(out, o)
            any_has = has if any_has is None else any_has | has
        return torch.where(any_has, out, torch.zeros((), dtype=out.dtype, device=out.device))
    if aggr in ("softmax", "softmax_sg", "softmax_sum"):
        grad_w = learn_t and aggr in ("softmax", "softmax_sum")
        t_eff = t.detach() if isinstance(t, torch.Tensor) and not grad_w else t
        with torch.no_grad():
            sm = None
            for (m, r, _, mk) in parts:
                mx = _segment_max_filled(m * t_eff, r, n, mk)
                sm = mx if sm is None else torch.maximum(sm, mx)
            sm = torch.where(torch.isfinite(sm), sm, torch.zeros((), dtype=sm.dtype,
                                                                  device=sm.device))
        es = []
        for (m, r, _, mk) in parts:
            rc = torch.clamp(r.long(), max=n - 1)
            e = torch.exp(m * t_eff - sm.index_select(0, rc))
            e = torch.where(_bcast(_valid(r, n, mk), e), e,
                            torch.zeros((), dtype=e.dtype, device=e.device))
            es.append(e)
        den = sum(segment_sum(e, r, n, row_ptr=rp) for e, (_, r, rp, _) in zip(es, parts))
        den = torch.clamp_min(den, torch.finfo(es[0].dtype).tiny)
        out = 0
        for e, (m, r, rp, _) in zip(es, parts):
            w = e / den.index_select(0, torch.clamp(r.long(), max=n - 1))
            if not grad_w:
                w = w.detach()  # the reference's no_grad weights
            out = out + segment_sum(w * m, r, n, row_ptr=rp)
        if aggr == "softmax_sum":
            out = torch.pow(deg(out.dtype), torch.sigmoid(torch.as_tensor(y)))[:, None] * out
        return out
    if aggr in ("power", "power_sum"):
        lo, hi = 1e-7, 1e1
        s = sums([torch.pow(torch.clamp(m, lo, hi), p) for (m, _, _, _) in parts])
        out = torch.clamp(s / _bcast(torch.clamp_min(deg(s.dtype), 1), s), lo, hi)
        out = torch.pow(out, 1.0 / p)
        if aggr == "power_sum":
            out = torch.pow(deg(out.dtype), torch.sigmoid(torch.as_tensor(y)))[:, None] * out
        return out
    raise NotImplementedError(f"aggregation '{aggr}' is not implemented")
