"""CSR segment sum (K1) and fused softmax aggregation (K2): CUDA kernels, their
plain PyTorch versions and the autograd Functions around them.

Counterpart of `deep_gcns_torch_tpu/ops/spmm_pallas.py:252-315, 322-412,
649-803`. The kernels are hand-written CUDA C++ for Hopper (`csrc/seg_sum.cu`,
`csrc/softmax_agg.cu`, built by `ops/_build.py`); each source names the TPU
kernel it replaces and what bounds it on the card.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises). Each kernel
wrapper counts its launches in a plain int attribute (`csr_seg_sum.launches`,
`softmax_agg.launches`), so a run can show that its main path went through
the kernels.

The TPU artifacts of the Pallas kernels (one-hot MXU matmuls, 128-lane
padding, the VMEM slot ring, BN/CHUNK tiles) are not carried over:
`fused_softmax_gather_agg_auto` has no lane padding left to do.
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
                      t: torch.Tensor, cmax: torch.Tensor, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, den) of K2: per receiver and channel, num = Σ round(w·m) and
    den = Σ round(w) in float32 with m = relu(x[send]) + ε, w = exp(t·m − cmax)
    and round() the rounding to x's dtype; out = num/den (0 where den = 0).
    Both outputs are in x's dtype."""
    edges, rows = _edge_rows(row_ptr)
    m = torch.relu(x.index_select(0, senders[edges].long()).float()) + eps
    w = torch.exp(m * t - cmax)
    shape = (row_ptr.shape[0] - 1, x.shape[1])
    num = torch.zeros(shape, dtype=torch.float32, device=x.device)
    den = torch.zeros(shape, dtype=torch.float32, device=x.device)
    num.index_add_(0, rows, (w * m).to(x.dtype).float())
    den.index_add_(0, rows, w.to(x.dtype).float())
    pos = den > 0
    out = torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)
    return out.to(x.dtype), den.to(x.dtype)


def softmax_agg(x: torch.Tensor, senders: torch.Tensor, row_ptr: torch.Tensor,
                t: torch.Tensor, cmax: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (`csrc/softmax_agg.cu`) on a CUDA tensor; the plain version on a CPU
    one. ``t`` is a float32 one-element tensor read on the device."""
    if x.device.type == "cpu":
        return softmax_agg_plain(x, senders, row_ptr, t, cmax, eps)
    _check_rows("x", x)
    _check_index("senders", senders, x.device)
    _check_index("row_ptr", row_ptr, x.device)
    n_rows, c = row_ptr.shape[0] - 1, x.shape[1]
    _require(t.device == x.device and t.dtype == torch.float32 and t.numel() == 1,
             "t must be a one-element float32 tensor on x's device")
    _require(cmax.device == x.device and cmax.dtype == torch.float32
             and cmax.shape == (c,) and cmax.is_contiguous(),
             "cmax must be a contiguous float32 [C] tensor on x's device")
    out = torch.empty((n_rows, c), dtype=x.dtype, device=x.device)
    den = torch.empty((n_rows, c), dtype=x.dtype, device=x.device)
    if n_rows == 0 or c == 0:
        return out, den
    t = t.contiguous()
    fn = getattr(library("softmax_agg"), f"dgc_softmax_agg_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), senders.data_ptr(), row_ptr.data_ptr(), t.data_ptr(),
            cmax.data_ptr(), out.data_ptr(), den.data_ptr(), n_rows, c, float(eps),
            _vec(c, x, out, den, cmax), torch.cuda.current_stream(x.device).cuda_stream)
    softmax_agg.launches += 1
    _raise_on(rc, "K2 softmax_agg")
    return out, den


softmax_agg.launches = 0


def fused_cmax(x: torch.Tensor, t: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-channel GLOBAL upper bound of the scores t·(relu(x_j) + ε) over all
    N_pad rows, padding included (`_fused_cmax`, spmm_pallas.py:649-662).
    relu commutes with the max, so the max is taken in x's dtype."""
    m_ub = torch.clamp_min(x.detach().amax(0).float(), 0.0) + eps
    return torch.where(t > 0, t * m_ub, t * eps)


class _FusedSoftmaxGatherAgg(torch.autograd.Function):
    """Forward: K2. Backward: the node-factored formula of
    spmm_pallas.py:727-760 with Aᵀq through K1 with the fused gather:

        softmax_sg: dx = relu'(x) ⊙ E ⊙ Aᵀq
        learn_t:    dx = relu'(x) ⊙ E ⊙ [(1 + t·M)·S₁ − t·S₂],
                    dt = Σ E⊙M⊙(M⊙S₁ − S₂),   [S₁|S₂] = Aᵀ[q | q⊙out]

    with q = g/den, M = relu(x) + ε and E = exp(t·M − cmax). It holds only
    because cmax is one shift for every receiver."""

    @staticmethod
    def forward(ctx, x, t, senders, row_ptr, csc_receivers, csc_col_ptr, eps,
                grad_weights, agg: Callable, seg: Callable):
        t32 = t.detach().float().reshape(1)
        cmax = fused_cmax(x, t32, eps)
        out, den = agg(x, senders, row_ptr, t32, cmax, eps)
        ctx.save_for_backward(x, t32, den, cmax, csc_receivers, csc_col_ptr,
                              out if grad_weights else None)
        ctx.eps, ctx.grad_weights, ctx.seg, ctx.t_shape = eps, grad_weights, seg, t.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, t, den, cmax, csc_receivers, csc_col_ptr, out = ctx.saved_tensors
        den = den.float()
        pos = den > 0
        q = torch.where(pos, g.float() / torch.where(pos, den, 1.0), 0.0)
        m_node = torch.relu(x.float()) + ctx.eps
        e_node = torch.exp(m_node * t - cmax)
        qo = torch.cat([q, q * out.float()], 1) if ctx.grad_weights else q
        s_all = ctx.seg(qo.to(x.dtype).contiguous(), csc_col_ptr, csc_receivers).float()
        dt = None
        if ctx.grad_weights:
            c = x.shape[1]
            s1, s2 = s_all[:, :c], s_all[:, c:]
            dm = e_node * ((1.0 + t * m_node) * s1 - t * s2)
            dt = (e_node * m_node * (m_node * s1 - s2)).sum().reshape(ctx.t_shape)
        else:
            dm = e_node * s_all
        dx = torch.where(x > 0, dm, 0.0).to(x.dtype)
        return dx, dt, None, None, None, None, None, None, None, None


def fused_softmax_gather_agg(x: torch.Tensor, senders: torch.Tensor,
                             row_ptr: torch.Tensor, csc_receivers: torch.Tensor,
                             csc_col_ptr: torch.Tensor, t: torch.Tensor,
                             eps: float = 1e-7, grad_weights: bool = False
                             ) -> torch.Tensor:
    """GENConv aggregation fused at the node level (no edge embeddings):

        out[n] = Σ_{e: recv=n} softmax_e(t·m_e)·m_e,   m_e = relu(x[send_e]) + ε

    ``grad_weights`` False keeps the reference's stop-gradient softmax
    weights (softmax_sg); True differentiates through them and through ``t``.
    The edge ranges come from ``row_ptr`` (receiver-sorted) and
    ``csc_col_ptr`` (sender-sorted), so sentinel edges are never read."""
    return _FusedSoftmaxGatherAgg.apply(x, t, senders, row_ptr, csc_receivers,
                                        csc_col_ptr, eps, grad_weights,
                                        softmax_agg, csr_seg_sum)


def fused_softmax_gather_agg_plain(x, senders, row_ptr, csc_receivers, csc_col_ptr,
                                   t, eps: float = 1e-7, grad_weights: bool = False):
    """The same Function on the plain versions of K1 and K2, on any device:
    the oracle that the kernels' forward and backward are held against."""
    return _FusedSoftmaxGatherAgg.apply(x, t, senders, row_ptr, csc_receivers,
                                        csc_col_ptr, eps, grad_weights,
                                        softmax_agg_plain, csr_seg_sum_plain)


# the call site's name in the JAX package; on the GPU there are no lanes to pad
fused_softmax_gather_agg_auto = fused_softmax_gather_agg
