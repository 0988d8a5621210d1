"""CSR segment sum (K1), fused softmax aggregation (K2, with or without edge
embeddings, and its form over materialised messages), its CSC backward (K4,
with or without edge embeddings), and the GAT attention SpMM (K5 forward,
K6 CSC backward): CUDA kernels, their plain PyTorch versions and the
autograd Functions around them. GENConv's softmax shifts each receiver by
its own maximum score (the reference's scatter_softmax), where the JAX
package shifts by one global bound a channel: K2 returns each receiver's
log-normaliser and K4 reads it per edge.

Counterpart of `deep_gcns_torch_tpu/ops/spmm_pallas.py:252-315, 322-459,
466-803, 805-996`. The kernels are hand-written CUDA C++ for Hopper
(`csrc/seg_sum.cu`, `csrc/softmax_agg.cu`, `csrc/softmax_bwd_csc.cu`,
`csrc/gat_fwd.cu`, `csrc/gat_bwd_csc.cu`, built by `ops/_build.py`); each
source names the TPU kernel it replaces and what bounds it on the card.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises). Each kernel
wrapper counts its launches in a plain int attribute (`csr_seg_sum.launches`,
`softmax_agg.launches` and, for its edge-embedding form,
`softmax_agg.launches_ee`, `softmax_agg_msgs.launches` for its message form,
with `softmax_agg.split_rows` the long rows its gather forms split over warps,
`softmax_bwd_csc.launches`, `gat_fwd.launches`,
`gat_bwd_csc.launches`), so a run can show that its main path went through
the kernels.

The TPU artifacts of the Pallas kernels (one-hot MXU matmuls, 128-lane
padding, the VMEM slot ring, BN/CHUNK tiles) are not carried over:
`fused_softmax_gather_agg_auto` has no lane padding left to do, and the GAT
table needs none either (its callers pad it to a multiple of 8 columns only
so that the kernels take their wide loads).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.profiling import span
from ._build import library

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------

def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_index(name: str, a: torch.Tensor, dev: torch.device):
    _require(a.device == dev, f"{name} is on {a.device}, expected {dev}")
    _require(a.dtype == torch.int32, f"{name} must be int32, got {a.dtype}")
    _require(a.ndim == 1 and a.is_contiguous(), f"{name} must be 1-D contiguous")


def _check_rows(name: str, a: torch.Tensor):
    _require(a.device.type == "cuda", f"{name} must be a CUDA tensor")
    _require(a.dtype in _SUFFIX, f"{name} must be float32 or bfloat16, got {a.dtype}")
    _require(a.ndim == 2 and a.is_contiguous(), f"{name} must be 2-D contiguous")


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """4-wide loads when every row start is aligned for them, else scalar."""
    return 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


# K2's long-row split: a receiver row of more than this many edges is walked
# by ⌈C/32⌉ warps, one 32-channel slice each, in the one-group layout
# (`csrc/softmax_agg.cu`). Chosen on an H100 from 64, 128 and 256 (PERF.md).
K2_SPLIT_EDGES = 128


def k2_split_rows(row_ptr) -> int:
    """How many rows of the ranges ``row_ptr`` (host numpy, or None) K2
    splits over warps: those of more than `K2_SPLIT_EDGES` edges, which
    `graph.longest_first` puts first in ``row_order``. `graph.build_graph`
    stores the count as `Graph.split_rows`."""
    if row_ptr is None:
        return 0
    return int((row_ptr[1:] - row_ptr[:-1] > K2_SPLIT_EDGES).sum())


def k2_lane_groups(c: int, vec: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(w, G): K2 splits a warp's 32 lanes into G groups of w lanes, each
    group walking every G-th edge of the row with w·vec channels; a row wider
    than 32·vec takes w = 32, G = 1 and walks its channels in chunks. float32
    takes one group, whose walk adds the terms in edge order as the plain
    version does (a hub row's float32 sum depends on that order by more than
    their 1e-5 agreement)."""
    if dtype == torch.float32:
        return 32, 1
    w = min(32, -(-c // vec))
    return w, 32 // w


# the widest bf16 row (C % 8 == 0) that K1 reads with 16-byte loads (vec 8);
# wider rows take 8-byte loads over several slots a lane (at C=256 they beat
# 16-byte loads on the band leftover: 0.071 against 0.079 ms on an H100)
K1_WIDE_LOADS_MAX_C = 128


def k1_layout(c: int, vec: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(w, G): K1 gives a row of w = ⌈C/vec⌉ ≤ 16 vector slots a lane group of
    w lanes, G = 32 // w rows a warp (C=8 float32: 2 lanes, 16 rows; C=48
    bf16: 12 lanes, 2 rows); a wider row takes the whole warp (w = min(32,
    slots), G = 1), whose lanes hold all of its slots in one walk. Each group
    walks its own row, so every row still sums in edge order: unlike
    `k2_lane_groups`, float32 takes the same layout as bf16."""
    del dtype  # the same layout in both dtypes
    w = min(32, -(-c // vec))
    return w, 32 // w


def k4_lane_groups(c: int, vec: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(w, G) of K4: the same layout as K2's (G groups of w lanes over a
    sender row's edges in bf16, one group in float32, where a hub sender's
    row sums in edge order), chosen here so that a change to K2's layout
    does not move K4's."""
    return k2_lane_groups(c, vec, dtype)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _edge_rows(ptr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge ids, row id of each edge) of the CSR ranges [ptr[0], ptr[-1])."""
    n_rows = ptr.shape[0] - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n_rows, device=ptr.device), counts)
    start = int(ptr[0])
    edges = torch.arange(start, start + rows.shape[0], device=ptr.device)
    return edges, rows


# ---------------------------------------------------------------------------
# K1: CSR segment sum, optionally through a row gather
# ---------------------------------------------------------------------------

def csr_seg_sum_plain(src: torch.Tensor, ptr: torch.Tensor,
                      idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[n] = Σ_{e ∈ [ptr[n], ptr[n+1])} src[idx[e] if idx else e], summed in
    float32, returned in src's dtype."""
    edges, rows = _edge_rows(ptr)
    r = edges if idx is None else idx[edges].long()
    out = torch.zeros((ptr.shape[0] - 1, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    out.index_add_(0, rows, src.index_select(0, r).float())
    return out.to(src.dtype)


def csr_seg_sum(src: torch.Tensor, ptr: torch.Tensor,
                idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 (`csrc/seg_sum.cu`) on a CUDA tensor; the plain version on a CPU one."""
    if src.device.type == "cpu":
        return csr_seg_sum_plain(src, ptr, idx)
    _check_rows("src", src)
    _check_index("ptr", ptr, src.device)
    if idx is not None:
        _check_index("idx", idx, src.device)
    n_rows, c = ptr.shape[0] - 1, src.shape[1]
    out = torch.empty((n_rows, c), dtype=src.dtype, device=src.device)
    if n_rows == 0 or c == 0:
        return out
    vec = _vec(c, src, out)
    if vec == 4 and src.dtype == torch.bfloat16 and c % 8 == 0 and c <= K1_WIDE_LOADS_MAX_C:
        vec = 8
    w, groups = k1_layout(c, vec, src.dtype)
    fn = getattr(library("seg_sum"), f"dgc_seg_sum_{_SUFFIX[src.dtype]}")
    rc = fn(src.data_ptr(), None if idx is None else idx.data_ptr(), ptr.data_ptr(),
            out.data_ptr(), n_rows, c, vec, w, groups,
            torch.cuda.current_stream(src.device).cuda_stream)
    csr_seg_sum.launches += 1
    _raise_on(rc, "K1 seg_sum_csr")
    return out


csr_seg_sum.launches = 0


class _SegmentSumCSR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, receivers, row_ptr):
        ctx.save_for_backward(receivers)
        ctx.n_pad = row_ptr.shape[0] - 1
        return csr_seg_sum(msgs, row_ptr)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        n_pad = ctx.n_pad
        dm = g.index_select(0, torch.clamp(receivers.long(), max=n_pad - 1))
        dm = torch.where((receivers < n_pad)[:, None], dm,
                         torch.zeros((), dtype=dm.dtype, device=dm.device))
        return dm, None, None


def segment_sum_csr(msgs: torch.Tensor, receivers: torch.Tensor,
                    row_ptr: torch.Tensor) -> torch.Tensor:
    """Sum msgs [E_pad, C] into [N_pad, C] over the receiver-sorted CSR ranges
    of ``row_ptr``; the VJP gathers the cotangent by receiver (sentinel edges
    get 0)."""
    return _SegmentSumCSR.apply(msgs, receivers, row_ptr)




# ---------------------------------------------------------------------------
# K2: fused gather + message + softmax aggregation
# ---------------------------------------------------------------------------

def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation type: float32, or float64 for float64
    inputs (the gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _row_softmax_terms(m: torch.Tensor, rows: torch.Tensor, n_rows: int, t: torch.Tensor,
                       dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the per-receiver softmax aggregation of the messages
    ``m`` [E, C] (in `_acc(dtype)`) of the edges whose receiver rows are
    ``rows``: M = the row's maximum of round(t·m) in each channel,
    w = exp(t·m − M), num = Σ round(w·m) and den = Σ round(w) with round()
    the rounding to ``dtype``; out = num/den (0 where a row has no edge) in
    ``dtype``, lse = M + log(den) (0 there) in the accumulation type."""
    s = m * t
    shape = (n_rows, m.shape[1])
    mx = torch.full(shape, float("-inf"), dtype=m.dtype, device=m.device)
    mx.scatter_reduce_(0, rows[:, None].expand_as(s), s, "amax")
    w = torch.exp(s - mx.index_select(0, rows))
    num = torch.zeros(shape, dtype=m.dtype, device=m.device)
    den = torch.zeros(shape, dtype=m.dtype, device=m.device)
    num.index_add_(0, rows, (w * m).to(dtype).to(m.dtype))
    den.index_add_(0, rows, w.to(dtype).to(m.dtype))
    pos = den > 0
    safe = torch.where(pos, den, 1.0)
    out = torch.where(pos, num / safe, 0.0)
    lse = torch.where(pos, mx + torch.log(safe), 0.0)
    return out.to(dtype), lse


def softmax_agg_plain(x: torch.Tensor, senders: torch.Tensor, row_ptr: torch.Tensor,
                      row_order: Optional[torch.Tensor], t: torch.Tensor, eps: float,
                      ee: Optional[torch.Tensor] = None, split_rows: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of K2: per receiver row and channel, the softmax
    aggregation (`_row_softmax_terms`) of m = relu(x[send] [+ ee[e]]) + ε
    over the row's CSR range, shifted by the row's own maximum score.
    ``ee`` is in receiver order; out is in x's dtype, lse in float32 (float64
    for float64 inputs). Each row is summed alone, so ``row_order`` and
    ``split_rows`` (the kernel's order of the rows and its split of the
    longest) change nothing here."""
    del row_order, split_rows
    acc = _acc(x.dtype)
    edges, rows = _edge_rows(row_ptr)
    xj = x.index_select(0, senders[edges].long()).to(acc)
    if ee is not None:
        xj = xj + ee.index_select(0, edges).to(acc)
    m = torch.relu(xj) + eps
    return _row_softmax_terms(m, rows, row_ptr.shape[0] - 1, t, x.dtype)


def _check_order(name: str, order: torch.Tensor, ptr: torch.Tensor):
    _check_index(name, order, ptr.device)
    _require(order.shape[0] == ptr.shape[0] - 1,
             f"{name} must hold one entry per row of its pointer array")


def _check_t(t: torch.Tensor, x: torch.Tensor):
    _require(t.device == x.device and t.dtype == torch.float32 and t.numel() == 1,
             "t must be a one-element float32 tensor on x's device")


def _check_edge_rows(name: str, a: torch.Tensor, x: torch.Tensor, rows: int):
    _check_rows(name, a)
    _require(a.device == x.device and a.dtype == x.dtype and a.shape == (rows, x.shape[1]),
             f"{name} must be [{rows}, {x.shape[1]}] of x's dtype on x's device, got "
             f"{tuple(a.shape)} {a.dtype} on {a.device}")


def softmax_agg(x: torch.Tensor, senders: torch.Tensor, row_ptr: torch.Tensor,
                row_order: torch.Tensor, t: torch.Tensor, eps: float,
                ee: Optional[torch.Tensor] = None, split_rows: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (`csrc/softmax_agg.cu`) on a CUDA tensor; the plain version on a CPU
    one. ``row_order`` is the graph's (`Graph.row_order`): the rows longest
    first, the order in which the kernel hands them to warps. ``t`` is a
    float32 one-element tensor read on the device; ``ee`` (optional) holds
    one row per edge slot of ``senders``, in x's dtype. ``split_rows`` (the
    graph's `Graph.split_rows`) is how many of ``row_order``'s first rows
    the one-group layout (float32, and bf16 rows of 32 vector slots or more)
    walks with ⌈C/32⌉ warps, one 32-channel slice each: any count gives the
    same bits, only the pace moves. The grouped bf16 layouts split no row;
    ``softmax_agg.split_rows`` counts the rows a launch split. Returns (out
    in x's dtype, lse float32), both [rows of row_ptr, C]."""
    if x.device.type == "cpu":
        return softmax_agg_plain(x, senders, row_ptr, row_order, t, eps, ee, split_rows)
    _check_rows("x", x)
    _check_index("senders", senders, x.device)
    _check_index("row_ptr", row_ptr, x.device)
    _check_order("row_order", row_order, row_ptr)
    _check_t(t, x)
    if ee is not None:
        _check_edge_rows("ee", ee, x, senders.shape[0])
    n_rows, c = row_ptr.shape[0] - 1, x.shape[1]
    _require(0 <= split_rows <= n_rows, f"split_rows {split_rows} outside [0, {n_rows}]")
    out = torch.empty((n_rows, c), dtype=x.dtype, device=x.device)
    lse = torch.empty((n_rows, c), dtype=torch.float32, device=x.device)
    if n_rows == 0 or c == 0:
        return out, lse
    t = t.contiguous()
    vec = _vec(c, *((x, out, lse) if ee is None else (x, out, lse, ee)))
    w, groups = k2_lane_groups(c, vec, x.dtype)
    n_split = split_rows if groups == 1 else 0
    fn = getattr(library("softmax_agg"), f"dgc_softmax_agg_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), None if ee is None else ee.data_ptr(), senders.data_ptr(),
            row_ptr.data_ptr(), row_order.data_ptr(), t.data_ptr(),
            out.data_ptr(), lse.data_ptr(), n_rows, n_split, c, w, groups, float(eps), vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    if ee is None:
        softmax_agg.launches += 1
    else:
        softmax_agg.launches_ee += 1
    softmax_agg.split_rows += n_split
    _raise_on(rc, "K2 softmax_agg")
    return out, lse


softmax_agg.launches = 0     # K2 without edge embeddings
softmax_agg.launches_ee = 0  # K2 with edge embeddings (the `has_ee` form)
softmax_agg.split_rows = 0   # rows split over warps, summed over both forms' launches


# ---------------------------------------------------------------------------
# K4: the CSC backward, with edge embeddings or without (the gather form)
# ---------------------------------------------------------------------------

def softmax_bwd_csc_plain(x: torch.Tensor, ee_csc: Optional[torch.Tensor], qo: torch.Tensor,
                          lse: torch.Tensor, col_ptr: torch.Tensor,
                          col_order: Optional[torch.Tensor], csc_receivers: torch.Tensor,
                          t: torch.Tensor, eps: float, grad_weights: bool
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """(dx, dee_csc, dt) of K4. Per edge e of sender s's CSC range with
    receiver r: xj = x[s] [+ ee_csc[e]], m = relu(xj) + ε, a = exp(t·m −
    lse[r]) (the normalised weight), q = qo[r, :C]; dm = q·a·(1 + t·(m − o))
    with o = qo[r, C:] under ``grad_weights``, else q·a; dxj = dm where
    xj > 0. dee_csc[e] = dxj in ee's dtype (0 on rows outside every range;
    None without ``ee_csc``), dx[s] = Σ dxj rounded to x's dtype and summed
    in float32, dt = Σ q·a·m·(m − o) (None without ``grad_weights``).
    ``col_order``, the kernel's order of the sender rows, changes nothing
    here."""
    del col_order
    acc = _acc(x.dtype)
    edges, rows = _edge_rows(col_ptr)
    c = x.shape[1]
    xj = x.index_select(0, rows).to(acc)
    if ee_csc is not None:
        xj = xj + ee_csc.index_select(0, edges).to(acc)
    m = torch.relu(xj) + eps
    r = csc_receivers[edges].long()
    a = torch.exp(m * t - lse.index_select(0, r))
    qr = qo.index_select(0, r).to(acc)
    qa = qr[:, :c] * a
    dt = None
    if grad_weights:
        dl = m - qr[:, c:]
        dm = qa * (1.0 + t * dl)
        dt = (qa * m * dl).sum()
    else:
        dm = qa
    dxj = torch.where(xj > 0, dm, 0.0)
    dee = None
    if ee_csc is not None:
        dee = torch.zeros_like(ee_csc)
        dee[edges] = dxj.to(ee_csc.dtype)
    dx = torch.zeros(x.shape, dtype=acc, device=x.device)
    dx.index_add_(0, rows, dxj.to(x.dtype).to(acc))
    return dx.to(x.dtype), dee, dt


def softmax_bwd_csc(x: torch.Tensor, ee_csc: Optional[torch.Tensor], qo: torch.Tensor,
                    lse: torch.Tensor, col_ptr: torch.Tensor, col_order: torch.Tensor,
                    csc_receivers: torch.Tensor, t: torch.Tensor, eps: float,
                    grad_weights: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K4 (`csrc/softmax_bwd_csc.cu`) on a CUDA tensor; the plain version on a
    CPU one. ``qo`` is [N_pad, C] (the cotangent g of out) or, with
    ``grad_weights``, [N_pad, 2C] ([g | out]), in x's dtype; ``lse`` is K2's
    float32 [N_pad, C]; the kernel gathers both by receiver. ``col_order``
    is the graph's `Graph.csc_order` (the sender rows longest first). Without
    ``ee_csc`` (the gather form) no dee comes back. dt comes back as the
    float32 sum of one partial per sender row. Every form counts in
    ``softmax_bwd_csc.launches``."""
    if x.device.type == "cpu":
        return softmax_bwd_csc_plain(x, ee_csc, qo, lse, col_ptr, col_order, csc_receivers, t,
                                     eps, grad_weights)
    _check_rows("x", x)
    _check_index("col_ptr", col_ptr, x.device)
    _check_order("col_order", col_order, col_ptr)
    _check_index("csc_receivers", csc_receivers, x.device)
    _check_t(t, x)
    n_rows, c = col_ptr.shape[0] - 1, x.shape[1]
    e_pad = csc_receivers.shape[0]
    _require(n_rows == x.shape[0], f"col_ptr has {n_rows} ranges for {x.shape[0]} rows of x")
    if ee_csc is not None:
        _check_edge_rows("ee_csc", ee_csc, x, e_pad)
    _check_rows("qo", qo)
    qc = 2 * c if grad_weights else c
    _require(qo.dtype == x.dtype and qo.device == x.device and qo.shape == (n_rows, qc),
             f"qo must be [{n_rows}, {qc}] of x's dtype, got {tuple(qo.shape)} {qo.dtype}")
    _require(lse.device == x.device and lse.dtype == torch.float32
             and lse.shape == (n_rows, c) and lse.is_contiguous(),
             f"lse must be a contiguous float32 [{n_rows}, {c}] tensor on x's device")
    dx = torch.empty_like(x)
    dee = None if ee_csc is None else torch.empty_like(ee_csc)
    dt_part = (torch.empty(n_rows, dtype=torch.float32, device=x.device)
               if grad_weights else None)
    if n_rows == 0 or c == 0:
        return dx, None if dee is None else dee.zero_(), \
            None if dt_part is None else dt_part.sum()
    t = t.contiguous()
    vec = _vec(c, *(t_ for t_ in (x, ee_csc, qo, lse, dx, dee) if t_ is not None))
    w, groups = k4_lane_groups(c, vec, x.dtype)
    fn = getattr(library("softmax_bwd_csc"), f"dgc_softmax_bwd_csc_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), None if ee_csc is None else ee_csc.data_ptr(), qo.data_ptr(),
            lse.data_ptr(), col_ptr.data_ptr(), col_order.data_ptr(),
            csc_receivers.data_ptr(), t.data_ptr(),
            dx.data_ptr(), None if dee is None else dee.data_ptr(),
            None if dt_part is None else dt_part.data_ptr(), n_rows, c, e_pad, w, groups,
            float(eps), int(grad_weights), vec, torch.cuda.current_stream(x.device).cuda_stream)
    softmax_bwd_csc.launches += 1
    _raise_on(rc, "K4 softmax_bwd_csc")
    return dx, dee, None if dt_part is None else dt_part.sum()


softmax_bwd_csc.launches = 0


# ---------------------------------------------------------------------------
# the fused aggregation as one autograd Function
# ---------------------------------------------------------------------------

class _FusedSoftmaxGatherAgg(torch.autograd.Function):
    """Forward: K2 (with ``ee`` when there are edge embeddings), which also
    gives each receiver's log-normaliser lse.

    Backward: K4 over the CSC ranges (spmm_pallas.py:762-776 with edge
    embeddings), each edge's normalised weight exp(t·m − lse[r]) read per
    edge: with q = g,

        softmax_sg: dm = q·a,   learn_t: dm = q·a·(1 + t·(m − out[r])),
                                        dt = Σ q·a·m·(m − out[r])

    and dx = relu'(x_j) ⊙ dm summed over a sender's edges. The JAX package's
    node-factored backward without edge embeddings (spmm_pallas.py:727-760,
    a K1 segment sum of g/den times exp(t·M − cmax)) holds only under one
    shift for every receiver, so here the gather form walks the edges as
    well. With edge embeddings the whole edge cotangent goes to ``ee_csc``,
    and ``ee`` gets none."""

    @staticmethod
    def forward(ctx, x, t, ee, ee_csc, senders, row_ptr, row_order, csc_receivers,
                csc_col_ptr, csc_order, eps, grad_weights, ops, split_rows):
        agg, bwd = ops
        t32 = t.detach().to(_acc(x.dtype)).reshape(1)
        out, lse = agg(x, senders, row_ptr, row_order, t32, eps, ee, split_rows)
        ctx.save_for_backward(x, t32, lse, csc_receivers, csc_col_ptr, csc_order,
                              out if grad_weights else None, ee_csc)
        ctx.eps, ctx.grad_weights, ctx.t_like = eps, grad_weights, (t.shape, t.dtype)
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, g):
        with span("gen.aggregate_bwd"):
            x, t, lse, csc_receivers, csc_col_ptr, csc_order, out, ee_csc = ctx.saved_tensors
            qo = torch.cat([g.to(x.dtype), out], 1) if ctx.grad_weights else g.to(x.dtype)
            dx, dee, dt = ctx.bwd(x, ee_csc, qo.contiguous(), lse, csc_col_ptr, csc_order,
                                  csc_receivers, t, ctx.eps, ctx.grad_weights)
        if dt is not None:
            dt = dt.reshape(ctx.t_like[0]).to(ctx.t_like[1])
        return (dx, dt, None, dee) + (None,) * 10


def _fused(ops, x, senders, row_ptr, row_order, csc_receivers, csc_col_ptr, csc_order, t, ee,
           ee_csc, eps, grad_weights, split_rows):
    _require((ee is None) == (ee_csc is None),
             "edge embeddings come in both orders: pass ee and ee_csc, or neither")
    return _FusedSoftmaxGatherAgg.apply(x, t, ee, ee_csc, senders, row_ptr, row_order,
                                        csc_receivers, csc_col_ptr, csc_order, eps,
                                        grad_weights, ops, split_rows)


def fused_softmax_gather_agg(x: torch.Tensor, senders: torch.Tensor,
                             row_ptr: torch.Tensor, row_order: torch.Tensor,
                             csc_receivers: torch.Tensor, csc_col_ptr: torch.Tensor,
                             csc_order: torch.Tensor, t: torch.Tensor,
                             ee: Optional[torch.Tensor] = None,
                             ee_csc: Optional[torch.Tensor] = None,
                             eps: float = 1e-7, grad_weights: bool = False,
                             split_rows: int = 0) -> torch.Tensor:
    """GENConv aggregation fused at the node level:

        out[n] = Σ_{e: recv=n} softmax_e(t·m_e)·m_e,   m_e = relu(x[send_e] [+ ee_e]) + ε

    with each receiver's softmax shifted by its own maximum, as the
    reference's scatter_softmax does (the JAX package shifts by one global
    bound a channel). ``grad_weights`` False keeps the reference's
    stop-gradient softmax weights (softmax_sg); True differentiates through
    them and through ``t``. Edge embeddings come in both edge orders, as in
    the JAX package (spmm_pallas.py:666-686): ``ee`` in receiver order feeds
    the forward, ``ee_csc`` in sender order the backward (K4), which returns
    the whole edge cotangent for ``ee_csc``. Encode ``g.edge_attr`` and
    ``g.edge_attr_csc`` separately to make them; never permute on the card.
    The edge ranges come from ``row_ptr`` (receiver-sorted) and
    ``csc_col_ptr`` (sender-sorted), so sentinel edges are never read;
    ``row_order`` and ``csc_order`` are the graph's rows of each longest
    first (`Graph.row_order`, `Graph.csc_order`), the order in which K2 and
    K4 hand them to warps; K2 splits the first ``split_rows`` of
    ``row_order`` over several warps (`Graph.split_rows`, `softmax_agg`)."""
    return _fused((softmax_agg, softmax_bwd_csc), x, senders, row_ptr, row_order,
                  csc_receivers, csc_col_ptr, csc_order, t, ee, ee_csc, eps, grad_weights,
                  split_rows)


def fused_softmax_gather_agg_plain(x, senders, row_ptr, row_order, csc_receivers, csc_col_ptr,
                                   csc_order, t, ee=None, ee_csc=None, eps: float = 1e-7,
                                   grad_weights: bool = False, split_rows: int = 0):
    """The same Function on the plain versions of K2 and K4, on any device:
    the oracle that the kernels' forward and backward are held against."""
    return _fused((softmax_agg_plain, softmax_bwd_csc_plain), x, senders, row_ptr, row_order,
                  csc_receivers, csc_col_ptr, csc_order, t, ee, ee_csc, eps, grad_weights,
                  split_rows)


# the call site's name in the JAX package; on the GPU there are no lanes to pad
fused_softmax_gather_agg_auto = fused_softmax_gather_agg


# ---------------------------------------------------------------------------
# K2's message form: the softmax aggregation of materialised messages
# ---------------------------------------------------------------------------

def softmax_agg_msgs_plain(msgs: torch.Tensor, row_ptr: torch.Tensor, t: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of K2's message form: per receiver row of the CSR ranges
    and channel, the softmax aggregation (`_row_softmax_terms`) of the
    messages as they are, shifted by the row's own maximum of t·m; out in
    the messages' dtype, lse in float32."""
    edges, rows = _edge_rows(row_ptr)
    m = msgs.index_select(0, edges).to(_acc(msgs.dtype))
    return _row_softmax_terms(m, rows, row_ptr.shape[0] - 1, t, msgs.dtype)


def softmax_agg_msgs(msgs: torch.Tensor, row_ptr: torch.Tensor, t: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's message form (`csrc/softmax_agg.cu`, `dgc_softmax_agg_msgs_*`) on
    a CUDA tensor; the plain version on a CPU one. ``msgs`` [E_pad, C] are in
    receiver (CSR) order; ``t`` is a one-element float32 tensor read on the
    device. Returns (out in the messages' dtype, lse float32)."""
    if msgs.device.type == "cpu":
        return softmax_agg_msgs_plain(msgs, row_ptr, t)
    _check_rows("msgs", msgs)
    _check_index("row_ptr", row_ptr, msgs.device)
    _check_t(t, msgs)
    n_rows, c = row_ptr.shape[0] - 1, msgs.shape[1]
    out = torch.empty((n_rows, c), dtype=msgs.dtype, device=msgs.device)
    lse = torch.empty((n_rows, c), dtype=torch.float32, device=msgs.device)
    if n_rows == 0 or c == 0:
        return out, lse
    t = t.contiguous()
    vec = _vec(c, msgs, out, lse)
    w, groups = k2_lane_groups(c, vec, msgs.dtype)
    fn = getattr(library("softmax_agg"), f"dgc_softmax_agg_msgs_{_SUFFIX[msgs.dtype]}")
    rc = fn(msgs.data_ptr(), row_ptr.data_ptr(), t.data_ptr(), out.data_ptr(), lse.data_ptr(),
            n_rows, c, w, groups, vec, torch.cuda.current_stream(msgs.device).cuda_stream)
    softmax_agg_msgs.launches += 1
    _raise_on(rc, "K2 softmax_agg_msgs")
    return out, lse


softmax_agg_msgs.launches = 0  # K2's message form, counted apart from the gather forms


class _SoftmaxAggMsgs(torch.autograd.Function):
    """Forward: K2's message form, each receiver shifted by its own maximum
    (JAX's `_softmax_fwd`, spmm_pallas.py:425-435, takes one exact maximum a
    channel). Backward: JAX's `_softmax_bwd` (:438-456), which is XLA there
    too, with the normalised weight a = exp(t·m − lse[r]) from the saved
    float32 lse: dm = g[r]·a, or with ``grad_weights`` dm = g[r]·a·(1 +
    t·(m − out[r])) and dt = Σ g[r]·a·m·(m − out[r]); padding edges get 0."""

    @staticmethod
    def forward(ctx, msgs, t, receivers, row_ptr, grad_weights, agg):
        t32 = t.detach().to(_acc(msgs.dtype)).reshape(1)
        out, lse = agg(msgs.contiguous(), row_ptr, t32)
        ctx.save_for_backward(msgs, receivers, t32, lse, out if grad_weights else None)
        ctx.grad_weights, ctx.t_like = grad_weights, (t.shape, t.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        msgs, receivers, t, lse, out = ctx.saved_tensors
        n_pad = lse.shape[0]
        r = torch.clamp(receivers.long(), max=n_pad - 1)
        valid = (receivers < n_pad)[:, None]
        m = msgs.to(lse.dtype)
        a = torch.exp(m * t - lse.index_select(0, r))
        a = torch.where(valid, a, 0.0)
        g_e = g.to(lse.dtype).index_select(0, r)
        dt = None
        if ctx.grad_weights:
            dl = m - out.to(lse.dtype).index_select(0, r)
            ga = g_e.mul_(a)
            dm = ga * (1.0 + t * dl)
            dt = (ga * m * dl).sum().reshape(ctx.t_like[0]).to(ctx.t_like[1])
        else:
            dm = g_e.mul_(a)
        dm = torch.where(valid, dm, 0.0).to(msgs.dtype)
        return dm, dt, None, None, None, None


def _msgs_fn(agg, msgs, receivers, row_ptr, t, grad_weights):
    if not isinstance(t, torch.Tensor):
        t = torch.tensor([float(t)], dtype=torch.float32, device=msgs.device)
    return _SoftmaxAggMsgs.apply(msgs, t, receivers, row_ptr, grad_weights, agg)


def gen_softmax_aggregate_csr(msgs: torch.Tensor, receivers: torch.Tensor,
                              row_ptr: torch.Tensor, t, grad_weights: bool = False
                              ) -> torch.Tensor:
    """out[n] = Σ_{e→n} softmax_e(t·m_e)·m_e per channel over the receiver
    sorted messages ``msgs`` [E_pad, C] and their CSR ``row_ptr``
    (`gen_softmax_aggregate_csr`, spmm_pallas.py:416-459): K2's message form
    forward. ``grad_weights`` False keeps the reference's stop-gradient
    softmax weights (d out/d m = w, no gradient for ``t``); True
    differentiates through them and through ``t`` (a tensor or a float)."""
    return _msgs_fn(softmax_agg_msgs, msgs, receivers, row_ptr, t, grad_weights)


def gen_softmax_aggregate_csr_plain(msgs, receivers, row_ptr, t, grad_weights: bool = False):
    """The same Function on the plain version, on any device: the oracle the
    kernel's forward and backward are held against."""
    return _msgs_fn(softmax_agg_msgs_plain, msgs, receivers, row_ptr, t, grad_weights)


# ---------------------------------------------------------------------------
# K5 / K6: the GAT attention SpMM with sender-only scores
# ---------------------------------------------------------------------------

# edges per block of the plain versions: bounds their [E, P] float32
# intermediates at the main shape to a few hundred MB each
_PLAIN_EDGE_BLOCK = 1 << 18


def gat_cmax(T: torch.Tensor, hd: int, h: int) -> torch.Tensor:
    """The per-head GLOBAL shift of the attention weights (`_gat_cmax`,
    spmm_pallas.py:892-895): max of el over all N_pad rows of the table,
    clamped at 0 (the sentinel rows' score), float32 [h], no gradient."""
    el_max = T[:, hd:hd + h].detach().float().amax(0)
    return torch.where(el_max >= 0, el_max, 0.0)


def _gat_weights(el: torch.Tensor, cmax: torch.Tensor, neg_slope: float) -> torch.Tensor:
    return torch.exp(torch.where(el >= 0, el, el * neg_slope) - cmax)


def gat_fwd_plain(T: torch.Tensor, senders: torch.Tensor, receivers_eff: torch.Tensor,
                  row_ptr: torch.Tensor, cmax: torch.Tensor, hd: int, h: int,
                  neg_slope: float) -> torch.Tensor:
    """K5's function: for each receiver row and head, over the CSR edges
    whose receiver is still that row, [Σ round(w·msg) | Σ round(w)] with
    w = exp(lrelu(el[send]) − cmax), summed in float32 and returned in T's
    dtype, zeros in the columns past hd + h."""
    n_rows, p = T.shape
    d = hd // h
    edges, rows = _edge_rows(row_ptr)
    kept = receivers_eff[edges].long() == rows
    edges, rows = edges[kept], rows[kept]
    acc = torch.zeros((n_rows, hd + h), dtype=torch.float32, device=T.device)
    for a in range(0, edges.shape[0], _PLAIN_EDGE_BLOCK):
        e_b, r_b = edges[a:a + _PLAIN_EDGE_BLOCK], rows[a:a + _PLAIN_EDGE_BLOCK]
        te = T.index_select(0, senders[e_b].long()).float()
        w = _gat_weights(te[:, hd:hd + h], cmax, neg_slope)
        terms = torch.cat([te[:, :hd] * w.repeat_interleave(d, 1), w], 1)
        acc.index_add_(0, r_b, terms.to(T.dtype).float())
    return torch.nn.functional.pad(acc, (0, p - hd - h)).to(T.dtype)


def _check_gat(T: torch.Tensor, cmax: torch.Tensor, hd: int, h: int):
    _check_rows("T", T)
    _require(h > 0 and hd % h == 0 and hd + h <= T.shape[1],
             f"T of width {T.shape[1]} cannot hold {h} heads of {hd // max(h, 1)} columns "
             "and el")
    _require(cmax.device == T.device and cmax.dtype == torch.float32
             and cmax.shape == (h,) and cmax.is_contiguous(),
             "cmax must be a contiguous float32 [h] tensor on T's device")


# K5's walk forms: `nch` groups of 32·vec columns a lane across a row's H·D
# columns, by vec (a wider row walks its columns in chunks)
_K5_FORMS = {4: (1, 2, 3), 1: (8,)}


def k5_layout(h: int, d: int, vec: int, dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[int, int, int]:
    """(nch, w, G) of K5, whose warp walks a receiver row's H·D columns: in
    bf16 a row of at most 16·vec columns takes K2's lane groups (G groups of
    w lanes, each every G-th kept edge; 1 x 40 → 3 x 10 lanes) and nch 1;
    otherwise one group (w = 32, G = 1, float32 always, in edge order) and
    the fewest of K5's forms that cover H·D, or the widest, which walks a
    wider row (3 x 256) in column chunks."""
    hd = h * d
    w, groups = k2_lane_groups(hd, vec, dtype)
    if groups > 1:
        return 1, w, groups
    need = -(-hd // (32 * vec))
    forms = _K5_FORMS[vec]
    return next((f for f in forms if f >= need), forms[-1]), 32, 1


def _gat_vec(d: int, p: int, *tables: torch.Tensor) -> int:
    """The loads of a K5/K6 launch: 4-wide when the head width D and the row
    width P are multiples of 4 and every table is aligned, else scalar. K6
    walks whole heads, so a head may be at most 256·vec columns wide."""
    vec = _vec(d, *tables) if p % 4 == 0 else 1
    _require(d <= 256 * vec, f"a head of {d} columns is wider than the kernels take "
                             f"({256 * vec} with these loads)")
    return vec


# K6's walk forms: `nch` groups of 32·vec columns a lane, by vec; a walk
# takes whole heads, and a head wider than these forms (vec 4: over 768
# columns) takes `_K6_WIDE`
_K6_FORMS = {4: (1, 2, 3, 6), 1: (8,)}
_K6_WIDE = 8


def k6_lane_groups(hd: int, vec: int, dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[int, int]:
    """(w, G) of K6: in bf16 a row of at most 16·vec columns takes two lane
    groups of 16, each every other kept edge, whose dot butterflies stay
    inside the group (1 x 40); otherwise one group of 32, and float32 always,
    in edge order."""
    return (16, 2) if dtype == torch.bfloat16 and hd <= 16 * vec else (32, 1)


def k6_layout(h: int, d: int, vec: int, dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[int, int, int]:
    """(nch, w, G) of K6, whose warp walks a sender row's H·D columns in
    walks of whole heads (each (edge, head) dot completes within one walk):
    `k6_lane_groups`' groups with nch 1, or one group and, of the forms that
    hold a head, the one with the fewest walks (then the narrowest): 3 x 128
    one walk of 3 groups, 3 x 256 one walk of 6."""
    w, groups = k6_lane_groups(h * d, vec, dtype)
    if groups > 1:
        return 1, w, groups
    forms = [f for f in _K6_FORMS[vec] if f * 32 * vec >= d] or [_K6_WIDE]

    def walks(f):
        return -(-h // min(h, f, f * 32 * vec // d))
    return min(forms, key=lambda f: (walks(f), f)), 32, 1


def gat_fwd(T: torch.Tensor, senders: torch.Tensor, receivers_eff: torch.Tensor,
            row_ptr: torch.Tensor, cmax: torch.Tensor, hd: int, h: int,
            neg_slope: float) -> torch.Tensor:
    """K5 (`csrc/gat_fwd.cu`) on a CUDA tensor; the plain version on a CPU
    one. ``T`` is [N_pad, P] = [msg (hd) | el (h) | zeros]; ``senders`` and
    ``receivers_eff`` (dropped edges carry the sentinel N_pad) are in
    receiver order, with the CSR ``row_ptr``."""
    if T.device.type == "cpu":
        return gat_fwd_plain(T, senders, receivers_eff, row_ptr, cmax, hd, h, neg_slope)
    _check_gat(T, cmax, hd, h)
    for name, a in (("senders", senders), ("receivers_eff", receivers_eff),
                    ("row_ptr", row_ptr)):
        _check_index(name, a, T.device)
    _require(senders.shape == receivers_eff.shape,
             "senders and receivers_eff must have one entry per edge slot")
    n_rows, p = row_ptr.shape[0] - 1, T.shape[1]
    out = torch.empty((n_rows, p), dtype=T.dtype, device=T.device)
    if n_rows == 0:
        return out
    vec = _gat_vec(hd // h, p, T, out)
    nch, w, groups = k5_layout(h, hd // h, vec, T.dtype)
    fn = getattr(library("gat_fwd"), f"dgc_gat_fwd_{_SUFFIX[T.dtype]}")
    rc = fn(T.data_ptr(), senders.data_ptr(), receivers_eff.data_ptr(), row_ptr.data_ptr(),
            cmax.data_ptr(), out.data_ptr(), n_rows, p, hd // h, h, float(neg_slope), vec, nch,
            w, groups, torch.cuda.current_stream(T.device).cuda_stream)
    gat_fwd.launches += 1
    _raise_on(rc, "K5 gat_fwd")
    return out


gat_fwd.launches = 0


def gat_bwd_csc_plain(T: torch.Tensor, g: torch.Tensor, col_ptr: torch.Tensor,
                      csc_receivers: torch.Tensor, keep_csc: Optional[torch.Tensor],
                      cmax: torch.Tensor, hd: int, h: int, neg_slope: float) -> torch.Tensor:
    """K6's function: per sender row s, over its kept CSC edges with
    receiver r, dT[s] = [Σ round(w·gnum) | Σ round((⟨msg, gnum⟩_h + gden)·w·
    lrelu'(el))] with w = exp(lrelu(el[s]) − cmax) and [gnum | gden] = g[r],
    summed in float32 and returned in T's dtype, zeros past hd + h."""
    n_rows, p = T.shape
    d = hd // h
    edges, rows = _edge_rows(col_ptr)
    if keep_csc is not None:
        kept = keep_csc[edges]
        edges, rows = edges[kept], rows[kept]
    acc = torch.zeros((n_rows, hd + h), dtype=torch.float32, device=T.device)
    for a in range(0, edges.shape[0], _PLAIN_EDGE_BLOCK):
        e_b, r_b = edges[a:a + _PLAIN_EDGE_BLOCK], rows[a:a + _PLAIN_EDGE_BLOCK]
        te = T.index_select(0, r_b).float()
        qg = g.index_select(0, csc_receivers[e_b].long()).float()
        el = te[:, hd:hd + h]
        w = _gat_weights(el, cmax, neg_slope)
        gnum = qg[:, :hd]
        dot = (te[:, :hd] * gnum).reshape(-1, h, d).sum(-1)
        d_el = (dot + qg[:, hd:hd + h]) * w * torch.where(el >= 0, 1.0, neg_slope)
        terms = torch.cat([gnum * w.repeat_interleave(d, 1), d_el], 1)
        acc.index_add_(0, r_b, terms.to(T.dtype).float())
    return torch.nn.functional.pad(acc, (0, p - hd - h)).to(T.dtype)


def gat_bwd_csc(T: torch.Tensor, g: torch.Tensor, col_ptr: torch.Tensor,
                csc_receivers: torch.Tensor, keep_csc: Optional[torch.Tensor],
                cmax: torch.Tensor, hd: int, h: int, neg_slope: float) -> torch.Tensor:
    """K6 (`csrc/gat_bwd_csc.cu`) on a CUDA tensor; the plain version on a CPU
    one. ``g`` is the cotangent of K5's output in T's dtype; ``keep_csc`` an
    optional bool [E_pad] in CSC order (False: the edge was dropped)."""
    if T.device.type == "cpu":
        return gat_bwd_csc_plain(T, g, col_ptr, csc_receivers, keep_csc, cmax, hd, h,
                                 neg_slope)
    _check_gat(T, cmax, hd, h)
    _check_rows("g", g)
    _require(g.shape == T.shape and g.dtype == T.dtype and g.device == T.device,
             f"g must be a {tuple(T.shape)} tensor of T's dtype on T's device, got "
             f"{tuple(g.shape)} {g.dtype} on {g.device}")
    _check_index("col_ptr", col_ptr, T.device)
    _check_index("csc_receivers", csc_receivers, T.device)
    n_rows, p = T.shape
    _require(col_ptr.shape[0] == n_rows + 1, f"col_ptr has {col_ptr.shape[0] - 1} ranges "
                                             f"for {n_rows} rows of T")
    if keep_csc is not None:
        _require(keep_csc.device == T.device and keep_csc.dtype == torch.bool
                 and keep_csc.shape == csc_receivers.shape and keep_csc.is_contiguous(),
                 "keep_csc must be a contiguous bool tensor with one entry per edge slot")
    dT = torch.empty_like(T)
    if n_rows == 0:
        return dT
    vec = _gat_vec(hd // h, p, T, g, dT)
    nch, w, groups = k6_layout(h, hd // h, vec, T.dtype)
    fn = getattr(library("gat_bwd_csc"), f"dgc_gat_bwd_csc_{_SUFFIX[T.dtype]}")
    rc = fn(T.data_ptr(), g.data_ptr(), col_ptr.data_ptr(), csc_receivers.data_ptr(),
            None if keep_csc is None else keep_csc.data_ptr(), cmax.data_ptr(), dT.data_ptr(),
            n_rows, p, hd // h, h, float(neg_slope), vec, nch, w, groups,
            torch.cuda.current_stream(T.device).cuda_stream)
    gat_bwd_csc.launches += 1
    _raise_on(rc, "K6 gat_bwd_csc")
    return dT


gat_bwd_csc.launches = 0


class _GatSoftmaxSpmm(torch.autograd.Function):
    """Forward K5 over the CSR ranges, backward K6 over the CSC ranges
    (`gat_softmax_spmm`'s custom VJP, spmm_pallas.py:945-996). cmax is saved
    from the forward, so both see one shift."""

    @staticmethod
    def forward(ctx, T, senders, receivers_eff, row_ptr, csc_receivers, csc_col_ptr, keep_csc,
                hd, h, neg_slope, ops):
        fwd, ctx.bwd = ops
        cmax = gat_cmax(T, hd, h)
        ctx.save_for_backward(T, csc_receivers, csc_col_ptr, keep_csc, cmax)
        ctx.hd, ctx.h, ctx.neg_slope = hd, h, neg_slope
        return fwd(T, senders, receivers_eff, row_ptr, cmax, hd, h, neg_slope)

    @staticmethod
    def backward(ctx, g):
        T, csc_receivers, csc_col_ptr, keep_csc, cmax = ctx.saved_tensors
        dT = ctx.bwd(T, g.to(T.dtype).contiguous(), csc_col_ptr, csc_receivers, keep_csc,
                     cmax, ctx.hd, ctx.h, ctx.neg_slope)
        return (dT,) + (None,) * 10


def _gat(ops, T, senders, receivers_eff, row_ptr, csc_receivers, csc_col_ptr, keep_csc, hd,
         h, neg_slope):
    keep = None if keep_csc is None else (keep_csc > 0).contiguous()
    return _GatSoftmaxSpmm.apply(T.contiguous(), senders, receivers_eff, row_ptr,
                                 csc_receivers, csc_col_ptr, keep, hd, h, neg_slope, ops)


def gat_softmax_spmm(T: torch.Tensor, senders: torch.Tensor, receivers_eff: torch.Tensor,
                     row_ptr: torch.Tensor, csc_senders: torch.Tensor,
                     csc_receivers: torch.Tensor, csc_col_ptr: torch.Tensor,
                     keep_csc: Optional[torch.Tensor] = None, hd: int = 0, h: int = 1,
                     neg_slope: float = 0.2) -> torch.Tensor:
    """agg[n] = [Σ_e w_{e,h}·msg_{e,h,:} | Σ_e w_{e,h} | 0] over the edges
    into n, with w = exp(leaky_relu(el[send_e]) − cmax) per head, for the
    packed table T = [msg (hd) | el (h) | zero columns] (JAX's contract,
    spmm_pallas.py:926-942). Edge-drop: dropped edges carry the sentinel
    receiver N_pad in ``receivers_eff``, and ``keep_csc`` (float or bool, in
    CSC order) zeroes their cotangents. Normalisation (num/den) happens
    outside. ``csc_senders`` is part of the contract but not read: the CSC
    ranges of ``csc_col_ptr`` give each edge's sender."""
    del csc_senders
    return _gat((gat_fwd, gat_bwd_csc), T, senders, receivers_eff, row_ptr, csc_receivers,
                csc_col_ptr, keep_csc, hd, h, neg_slope)


def gat_softmax_spmm_plain(T, senders, receivers_eff, row_ptr, csc_senders, csc_receivers,
                           csc_col_ptr, keep_csc=None, hd: int = 0, h: int = 1,
                           neg_slope: float = 0.2) -> torch.Tensor:
    """The same Function on the plain versions of K5 and K6, on any device:
    the oracle the kernels are held against."""
    del csc_senders
    return _gat((gat_fwd_plain, gat_bwd_csc_plain), T, senders, receivers_eff, row_ptr,
                csc_receivers, csc_col_ptr, keep_csc, hd, h, neg_slope)
