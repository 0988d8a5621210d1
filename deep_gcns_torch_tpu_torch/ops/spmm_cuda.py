"""CSR segment sum (K1), fused softmax aggregation (K2, with or without edge
embeddings), its CSC backward with edge embeddings (K4), and the GAT
attention SpMM (K5 forward, K6 CSC backward): CUDA kernels, their plain
PyTorch versions and the autograd Functions around them.

Counterpart of `deep_gcns_torch_tpu/ops/spmm_pallas.py:252-315, 322-412,
466-803, 805-996`. The kernels are hand-written CUDA C++ for Hopper
(`csrc/seg_sum.cu`, `csrc/softmax_agg.cu`, `csrc/softmax_bwd_csc.cu`,
`csrc/gat_fwd.cu`, `csrc/gat_bwd_csc.cu`, built by `ops/_build.py`); each
source names the TPU kernel it replaces and what bounds it on the card.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises). Each kernel
wrapper counts its launches in a plain int attribute (`csr_seg_sum.launches`,
`softmax_agg.launches` and, for its edge-embedding form,
`softmax_agg.launches_ee`, `softmax_bwd_csc.launches`, `gat_fwd.launches`,
`gat_bwd_csc.launches`), so a run can show that its main path went through
the kernels.

The TPU artifacts of the Pallas kernels (one-hot MXU matmuls, 128-lane
padding, the VMEM slot ring, BN/CHUNK tiles) are not carried over:
`fused_softmax_gather_agg_auto` has no lane padding left to do, and the GAT
table needs none either (its callers pad it to a multiple of 8 columns only
so that the kernels take their wide loads).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

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
    fn = getattr(library("seg_sum"), f"dgc_seg_sum_{_SUFFIX[src.dtype]}")
    rc = fn(src.data_ptr(), None if idx is None else idx.data_ptr(), ptr.data_ptr(),
            out.data_ptr(), n_rows, c, _vec(c, src, out),
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

def softmax_agg_plain(x: torch.Tensor, senders: torch.Tensor, row_ptr: torch.Tensor,
                      t: torch.Tensor, cmax: torch.Tensor, eps: float,
                      ee: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, den) of K2: per receiver and channel, num = Σ round(w·m) and
    den = Σ round(w) in float32 with m = relu(x[send] [+ ee[e]]) + ε,
    w = exp(t·m − cmax) and round() the rounding to x's dtype; out = num/den
    (0 where den = 0). ``ee`` is in receiver order. Both outputs are in x's
    dtype."""
    edges, rows = _edge_rows(row_ptr)
    xj = x.index_select(0, senders[edges].long()).float()
    if ee is not None:
        xj = xj + ee.index_select(0, edges).float()
    m = torch.relu(xj) + eps
    w = torch.exp(m * t - cmax)
    shape = (row_ptr.shape[0] - 1, x.shape[1])
    num = torch.zeros(shape, dtype=torch.float32, device=x.device)
    den = torch.zeros(shape, dtype=torch.float32, device=x.device)
    num.index_add_(0, rows, (w * m).to(x.dtype).float())
    den.index_add_(0, rows, w.to(x.dtype).float())
    pos = den > 0
    out = torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)
    return out.to(x.dtype), den.to(x.dtype)


def _check_t_cmax(t: torch.Tensor, cmax: torch.Tensor, x: torch.Tensor):
    c = x.shape[1]
    _require(t.device == x.device and t.dtype == torch.float32 and t.numel() == 1,
             "t must be a one-element float32 tensor on x's device")
    _require(cmax.device == x.device and cmax.dtype == torch.float32
             and cmax.shape == (c,) and cmax.is_contiguous(),
             "cmax must be a contiguous float32 [C] tensor on x's device")


def _check_edge_rows(name: str, a: torch.Tensor, x: torch.Tensor, rows: int):
    _check_rows(name, a)
    _require(a.device == x.device and a.dtype == x.dtype and a.shape == (rows, x.shape[1]),
             f"{name} must be [{rows}, {x.shape[1]}] of x's dtype on x's device, got "
             f"{tuple(a.shape)} {a.dtype} on {a.device}")


def softmax_agg(x: torch.Tensor, senders: torch.Tensor, row_ptr: torch.Tensor,
                t: torch.Tensor, cmax: torch.Tensor, eps: float,
                ee: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (`csrc/softmax_agg.cu`) on a CUDA tensor; the plain version on a CPU
    one. ``t`` is a float32 one-element tensor read on the device; ``ee``
    (optional) holds one row per edge slot of ``senders``, in x's dtype."""
    if x.device.type == "cpu":
        return softmax_agg_plain(x, senders, row_ptr, t, cmax, eps, ee)
    _check_rows("x", x)
    _check_index("senders", senders, x.device)
    _check_index("row_ptr", row_ptr, x.device)
    _check_t_cmax(t, cmax, x)
    if ee is not None:
        _check_edge_rows("ee", ee, x, senders.shape[0])
    n_rows, c = row_ptr.shape[0] - 1, x.shape[1]
    out = torch.empty((n_rows, c), dtype=x.dtype, device=x.device)
    den = torch.empty((n_rows, c), dtype=x.dtype, device=x.device)
    if n_rows == 0 or c == 0:
        return out, den
    t = t.contiguous()
    vec = _vec(c, *((x, out, den) if ee is None else (x, out, den, ee)))
    w, groups = k2_lane_groups(c, vec, x.dtype)
    fn = getattr(library("softmax_agg"), f"dgc_softmax_agg_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), None if ee is None else ee.data_ptr(), senders.data_ptr(),
            row_ptr.data_ptr(), t.data_ptr(), cmax.data_ptr(), out.data_ptr(),
            den.data_ptr(), n_rows, c, w, groups, float(eps), vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    if ee is None:
        softmax_agg.launches += 1
    else:
        softmax_agg.launches_ee += 1
    _raise_on(rc, "K2 softmax_agg")
    return out, den


softmax_agg.launches = 0     # K2 without edge embeddings
softmax_agg.launches_ee = 0  # K2 with edge embeddings (the `has_ee` form)


def fused_cmax(x: torch.Tensor, t: torch.Tensor, eps: float,
               ee: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel GLOBAL upper bound of the scores t·(relu(x_j [+ ee_e]) + ε)
    (`_fused_cmax`, spmm_pallas.py:649-662): m_ub = max relu(x), over all
    N_pad rows, and with edge embeddings relu(m_ub + max ee) with the max
    over all E_pad rows of ``ee``, padding included (padded rows carry the
    edge encoder's bias). relu commutes with the max, so the maxima are
    taken in the inputs' dtype."""
    m_ub = torch.clamp_min(x.detach().amax(0).float(), 0.0)
    if ee is not None:
        m_ub = torch.relu(m_ub + ee.detach().amax(0).float())
    m_ub = m_ub + eps
    return torch.where(t > 0, t * m_ub, t * eps)


# ---------------------------------------------------------------------------
# K4: the CSC backward with edge embeddings
# ---------------------------------------------------------------------------

def softmax_bwd_csc_plain(x: torch.Tensor, ee_csc: torch.Tensor, qo: torch.Tensor,
                          col_ptr: torch.Tensor, csc_receivers: torch.Tensor,
                          t: torch.Tensor, cmax: torch.Tensor, eps: float,
                          grad_weights: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dee_csc, dt) of K4. Per edge e of sender s's CSC range with
    receiver r: xj = x[s] + ee_csc[e], m = relu(xj) + ε, w = exp(t·m − cmax),
    q = qo[r, :C]; dm = q·w·(1 + t·(m − o)) with o = qo[r, C:] under
    ``grad_weights``, else q·w; dxj = dm where xj > 0. dee_csc[e] = dxj in
    ee's dtype (0 on rows outside every range), dx[s] = Σ dxj rounded to x's
    dtype and summed in float32, dt = Σ q·w·m·(m − o) (None without
    ``grad_weights``)."""
    edges, rows = _edge_rows(col_ptr)
    c = x.shape[1]
    xj = x.index_select(0, rows).float() + ee_csc.index_select(0, edges).float()
    m = torch.relu(xj) + eps
    w = torch.exp(m * t - cmax)
    qr = qo.index_select(0, csc_receivers[edges].long()).float()
    qw = qr[:, :c] * w
    dt = None
    if grad_weights:
        dl = m - qr[:, c:]
        dm = qw * (1.0 + t * dl)
        dt = (qw * m * dl).sum()
    else:
        dm = qw
    dxj = torch.where(xj > 0, dm, 0.0)
    dee = torch.zeros_like(ee_csc)
    dee[edges] = dxj.to(ee_csc.dtype)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dx.index_add_(0, rows, dxj.to(x.dtype).float())
    return dx.to(x.dtype), dee, dt


def softmax_bwd_csc(x: torch.Tensor, ee_csc: torch.Tensor, qo: torch.Tensor,
                    col_ptr: torch.Tensor, csc_receivers: torch.Tensor, t: torch.Tensor,
                    cmax: torch.Tensor, eps: float, grad_weights: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K4 (`csrc/softmax_bwd_csc.cu`) on a CUDA tensor; the plain version on a
    CPU one. ``qo`` is [N_pad, C] (q = g/den) or, with ``grad_weights``,
    [N_pad, 2C] ([q | out]), in x's dtype; the kernel gathers its rows by
    receiver. dt comes back as the float32 sum of one partial per sender row."""
    if x.device.type == "cpu":
        return softmax_bwd_csc_plain(x, ee_csc, qo, col_ptr, csc_receivers, t, cmax, eps,
                                     grad_weights)
    _check_rows("x", x)
    _check_index("col_ptr", col_ptr, x.device)
    _check_index("csc_receivers", csc_receivers, x.device)
    _check_t_cmax(t, cmax, x)
    n_rows, c = col_ptr.shape[0] - 1, x.shape[1]
    e_pad = csc_receivers.shape[0]
    _require(n_rows == x.shape[0], f"col_ptr has {n_rows} ranges for {x.shape[0]} rows of x")
    _check_edge_rows("ee_csc", ee_csc, x, e_pad)
    _check_rows("qo", qo)
    qc = 2 * c if grad_weights else c
    _require(qo.dtype == x.dtype and qo.device == x.device and qo.shape == (n_rows, qc),
             f"qo must be [{n_rows}, {qc}] of x's dtype, got {tuple(qo.shape)} {qo.dtype}")
    dx = torch.empty_like(x)
    dee = torch.empty_like(ee_csc)
    dt_part = (torch.empty(n_rows, dtype=torch.float32, device=x.device)
               if grad_weights else None)
    if n_rows == 0 or c == 0:
        return dx, dee.zero_(), None if dt_part is None else dt_part.sum()
    t = t.contiguous()
    vec = _vec(c, x, ee_csc, qo, dx, dee, cmax)
    w, groups = k4_lane_groups(c, vec, x.dtype)
    fn = getattr(library("softmax_bwd_csc"), f"dgc_softmax_bwd_csc_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), ee_csc.data_ptr(), qo.data_ptr(), col_ptr.data_ptr(),
            csc_receivers.data_ptr(), t.data_ptr(), cmax.data_ptr(), dx.data_ptr(),
            dee.data_ptr(), None if dt_part is None else dt_part.data_ptr(), n_rows, c,
            e_pad, w, groups, float(eps), int(grad_weights), vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    softmax_bwd_csc.launches += 1
    _raise_on(rc, "K4 softmax_bwd_csc")
    return dx, dee, None if dt_part is None else dt_part.sum()


softmax_bwd_csc.launches = 0


# ---------------------------------------------------------------------------
# the fused aggregation as one autograd Function
# ---------------------------------------------------------------------------

class _FusedSoftmaxGatherAgg(torch.autograd.Function):
    """Forward: K2 (with ``ee`` when there are edge embeddings).

    Backward without edge embeddings: the node-factored formula of
    spmm_pallas.py:727-760 with Aᵀq through K1 with the fused gather:

        softmax_sg: dx = relu'(x) ⊙ E ⊙ Aᵀq
        learn_t:    dx = relu'(x) ⊙ E ⊙ [(1 + t·M)·S₁ − t·S₂],
                    dt = Σ E⊙M⊙(M⊙S₁ − S₂),   [S₁|S₂] = Aᵀ[q | q⊙out]

    with q = g/den, M = relu(x) + ε and E = exp(t·M − cmax). It holds only
    because cmax is one shift for every receiver. With edge embeddings the
    message is no node table, and the backward is K4 over the CSC ranges
    (spmm_pallas.py:762-776): the whole edge cotangent goes to ``ee_csc``,
    and ``ee`` gets none."""

    @staticmethod
    def forward(ctx, x, t, ee, ee_csc, senders, row_ptr, csc_receivers, csc_col_ptr, eps,
                grad_weights, ops):
        agg, seg, bwd = ops
        t32 = t.detach().float().reshape(1)
        cmax = fused_cmax(x, t32, eps, ee)
        out, den = agg(x, senders, row_ptr, t32, cmax, eps, ee)
        ctx.save_for_backward(x, t32, den, cmax, csc_receivers, csc_col_ptr,
                              out if grad_weights else None, ee_csc)
        ctx.eps, ctx.grad_weights, ctx.t_shape = eps, grad_weights, t.shape
        ctx.seg, ctx.bwd = seg, bwd
        return out

    @staticmethod
    def backward(ctx, g):
        x, t, den, cmax, csc_receivers, csc_col_ptr, out, ee_csc = ctx.saved_tensors
        den = den.float()
        pos = den > 0
        q = torch.where(pos, g.float() / torch.where(pos, den, 1.0), 0.0)
        dt = dee = None
        if ee_csc is not None:
            qo = torch.cat([q, out.float()], 1) if ctx.grad_weights else q
            dx, dee, dt = ctx.bwd(x, ee_csc, qo.to(x.dtype).contiguous(), csc_col_ptr,
                                  csc_receivers, t, cmax, ctx.eps, ctx.grad_weights)
            if dt is not None:
                dt = dt.reshape(ctx.t_shape)
            return dx, dt, None, dee, None, None, None, None, None, None, None
        m_node = torch.relu(x.float()) + ctx.eps
        e_node = torch.exp(m_node * t - cmax)
        qo = torch.cat([q, q * out.float()], 1) if ctx.grad_weights else q
        s_all = ctx.seg(qo.to(x.dtype).contiguous(), csc_col_ptr, csc_receivers).float()
        if ctx.grad_weights:
            c = x.shape[1]
            s1, s2 = s_all[:, :c], s_all[:, c:]
            dm = e_node * ((1.0 + t * m_node) * s1 - t * s2)
            dt = (e_node * m_node * (m_node * s1 - s2)).sum().reshape(ctx.t_shape)
        else:
            dm = e_node * s_all
        dx = torch.where(x > 0, dm, 0.0).to(x.dtype)
        return dx, dt, None, None, None, None, None, None, None, None, None


def _fused(ops, x, senders, row_ptr, csc_receivers, csc_col_ptr, t, ee, ee_csc, eps,
           grad_weights):
    _require((ee is None) == (ee_csc is None),
             "edge embeddings come in both orders: pass ee and ee_csc, or neither")
    return _FusedSoftmaxGatherAgg.apply(x, t, ee, ee_csc, senders, row_ptr, csc_receivers,
                                        csc_col_ptr, eps, grad_weights, ops)


def fused_softmax_gather_agg(x: torch.Tensor, senders: torch.Tensor,
                             row_ptr: torch.Tensor, csc_receivers: torch.Tensor,
                             csc_col_ptr: torch.Tensor, t: torch.Tensor,
                             ee: Optional[torch.Tensor] = None,
                             ee_csc: Optional[torch.Tensor] = None,
                             eps: float = 1e-7, grad_weights: bool = False
                             ) -> torch.Tensor:
    """GENConv aggregation fused at the node level:

        out[n] = Σ_{e: recv=n} softmax_e(t·m_e)·m_e,   m_e = relu(x[send_e] [+ ee_e]) + ε

    ``grad_weights`` False keeps the reference's stop-gradient softmax
    weights (softmax_sg); True differentiates through them and through ``t``.
    Edge embeddings come in both edge orders, as in the JAX package
    (spmm_pallas.py:666-686): ``ee`` in receiver order feeds the forward,
    ``ee_csc`` in sender order the backward (K4), which returns the whole
    edge cotangent for ``ee_csc``. Encode ``g.edge_attr`` and
    ``g.edge_attr_csc`` separately to make them; never permute on the card.
    The edge ranges come from ``row_ptr`` (receiver-sorted) and
    ``csc_col_ptr`` (sender-sorted), so sentinel edges are never read."""
    return _fused((softmax_agg, csr_seg_sum, softmax_bwd_csc), x, senders, row_ptr,
                  csc_receivers, csc_col_ptr, t, ee, ee_csc, eps, grad_weights)


def fused_softmax_gather_agg_plain(x, senders, row_ptr, csc_receivers, csc_col_ptr, t,
                                   ee=None, ee_csc=None, eps: float = 1e-7,
                                   grad_weights: bool = False):
    """The same Function on the plain versions of K1, K2 and K4, on any
    device: the oracle that the kernels' forward and backward are held
    against."""
    return _fused((softmax_agg_plain, csr_seg_sum_plain, softmax_bwd_csc_plain), x, senders,
                  row_ptr, csc_receivers, csc_col_ptr, t, ee, ee_csc, eps, grad_weights)


# the call site's name in the JAX package; on the GPU there are no lanes to pad
fused_softmax_gather_agg_auto = fused_softmax_gather_agg


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


def _gat_launch(d: int, p: int, *tables: torch.Tensor) -> Tuple[int, int]:
    """(vec, nch) of a K5/K6 launch: 4-wide loads when the head width D and
    the row width P are multiples of 4 and every table is aligned, and (K6)
    the number of 32·vec-column groups a lane walks per head."""
    vec = _vec(d, *tables) if p % 4 == 0 else 1
    groups = -(-d // (32 * vec))
    nch = next((n for n in (1, 2, 4, 8) if n >= groups), None)
    _require(nch is not None, f"a head of {d} columns is wider than the kernels take "
                              f"({256 * vec} with these loads)")
    return vec, nch


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
    vec, _ = _gat_launch(hd // h, p, T, out)
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
    vec, nch = _gat_launch(hd // h, p, T, g, dT)
    fn = getattr(library("gat_bwd_csc"), f"dgc_gat_bwd_csc_{_SUFFIX[T.dtype]}")
    rc = fn(T.data_ptr(), g.data_ptr(), col_ptr.data_ptr(), csc_receivers.data_ptr(),
            None if keep_csc is None else keep_csc.data_ptr(), cmax.data_ptr(), dT.data_ptr(),
            n_rows, p, hd // h, h, float(neg_slope), vec, nch,
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
