"""RevGAT's masked batch-statistics norm → affine → ReLU → dropout multiply
as one autograd Function (K11, `csrc/batch_norm_act.cu`), with its plain
PyTorch halves.

    y = relu((x − μ)·rstd·w + b)·mult

μ and the biased variance are the column statistics over the rows whose
``mask`` is true, cnt = max(Σ mask, 1) and rstd = rsqrt(var + eps): the
masked statistics of `nn.core.InstanceNorm`, as the JAX package's
`_batch_stats_norm` (`deep_gcns_torch_tpu/models/rev_gat.py:36-43`) computes
them. ``mult`` is a float tensor (RevGAT's shared dropout-mask chunk), or
``keep``, a bool mask whose kept values are divided by ``1 − rate`` (the
head's inverted dropout, `nn.core.dropout`'s arithmetic), or neither.

The backward recomputes z = x̂·w + b and the ReLU gate from x, μ and rstd
(z is not saved) and, with g = dy·mult·[z > 0] over every row,

    db = Σ g,  dw = Σ g·x̂,  dx = rstd·(w·g − mask/cnt·(w·db + x̂·w·dw)):

the exact gradient of the eager chain, pad rows included (they use μ and
rstd but add nothing to them). ``mult`` and ``keep`` get no cotangent.

Dispatch is by the tensor's device, as in `ops/spmm_cuda.py`: a CPU tensor
takes the plain halves (the forward is the eager chain's arithmetic), a CUDA
tensor launches the kernels (or raises). `batch_norm_act_fwd.launches` and
`batch_norm_act_bwd.launches` count the kernel calls. x, ``mult`` and the
cotangent may be views with a row stride (the reversible coupling's
`torch.chunk` views): the kernels read them in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import library
from .spmm_cuda import _raise_on, _require

_SLAB_ROWS = 256  # kSlabRows of csrc/batch_norm_act.cu


def _apply_mult(v: torch.Tensor, mult: Optional[torch.Tensor], keep: Optional[torch.Tensor],
                div: float) -> torch.Tensor:
    if mult is not None:
        return v * mult
    if keep is not None:
        return torch.where(keep, v / div, torch.zeros((), dtype=v.dtype, device=v.device))
    return v


def batch_norm_act_fwd_plain(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, mult: Optional[torch.Tensor] = None,
                             keep: Optional[torch.Tensor] = None, div: float = 1.0,
                             eps: float = 1e-5
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, μ, rstd, cnt) by the eager chain's arithmetic."""
    m = mask[:, None].to(x.dtype)
    cnt = torch.clamp_min(m.sum(), 1.0)
    mu = (x * m).sum(0) / cnt
    var = (torch.square(x - mu) * m).sum(0) / cnt
    rstd = torch.rsqrt(var + eps)
    h = torch.relu((x - mu) * rstd * weight + bias)
    return _apply_mult(h, mult, keep, div), mu, rstd, cnt


def batch_norm_act_bwd_plain(dy: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                             weight: torch.Tensor, bias: torch.Tensor,
                             mult: Optional[torch.Tensor], keep: Optional[torch.Tensor],
                             div: float, mu: torch.Tensor, rstd: torch.Tensor, cnt: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) by the formula of the module docstring."""
    xh = (x - mu) * rstd
    z = xh * weight + bias
    g = _apply_mult(dy, mult, keep, div)
    g = torch.where(z > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    db = g.sum(0)
    dw = (g * xh).sum(0)
    m = mask[:, None].to(x.dtype)
    dx = rstd * (weight * g - m / cnt * (weight * db + xh * (weight * dw)))
    return dx, dw, db


# ---------------------------------------------------------------------------
# K11 on the card
# ---------------------------------------------------------------------------

def _check_rows(name: str, a: torch.Tensor, x: torch.Tensor, dtype: torch.dtype):
    _require(a.device == x.device and a.dtype == dtype and a.shape == x.shape
             and a.stride(1) == 1,
             f"{name} must be a {tuple(x.shape)} {dtype} tensor on {x.device} with column "
             f"stride 1, got {tuple(a.shape)} {a.dtype} on {a.device}, strides {a.stride()}")


def _check_cols(name: str, a: torch.Tensor, x: torch.Tensor):
    _require(a.device == x.device and a.dtype == torch.float32 and a.ndim == 1
             and a.shape[0] == x.shape[1] and a.is_contiguous(),
             f"{name} must be a contiguous float32 [{x.shape[1]}] tensor on {x.device}")


def _check_inputs(x, mask, weight, bias, mult, keep):
    _require(x.device.type == "cuda", "x must be a CUDA tensor")
    _require(x.dtype == torch.float32 and x.ndim == 2 and x.stride(1) == 1,
             f"x must be a 2-D float32 tensor with column stride 1, got {x.dtype} "
             f"{tuple(x.shape)} strides {x.stride()}")
    _require(mask.device == x.device and mask.dtype == torch.bool
             and mask.shape == (x.shape[0],) and mask.is_contiguous(),
             f"mask must be a contiguous bool [{x.shape[0]}] tensor on {x.device}")
    _check_cols("weight", weight, x)
    _check_cols("bias", bias, x)
    _require(mult is None or keep is None, "give mult or keep, not both")
    if mult is not None:
        _check_rows("mult", mult, x, torch.float32)
    if keep is not None:
        _check_rows("keep", keep, x, torch.bool)


def _mult_args(mult, keep) -> Tuple[Optional[int], int, int]:
    """(pointer, row stride, mode) of the multiplier."""
    if mult is not None:
        return mult.data_ptr(), mult.stride(0), 1
    if keep is not None:
        return keep.data_ptr(), keep.stride(0), 2
    return None, 0, 0


def _vec(c: int, rows, cols) -> int:
    """4-wide loads when C and every row stride are multiples of 4 and every
    pointer is aligned for them (a keep mask's 4 bytes), else scalar."""
    ok = c % 4 == 0
    for t, align in rows:
        if t is not None:
            ok = ok and t.stride(0) % 4 == 0 and t.data_ptr() % align == 0
    return 4 if ok and all(t.data_ptr() % 16 == 0 for t in cols) else 1


def batch_norm_act_fwd(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, mult: Optional[torch.Tensor] = None,
                       keep: Optional[torch.Tensor] = None, div: float = 1.0, eps: float = 1e-5
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11's forward on a CUDA tensor (y, μ, rstd, cnt [1], all on the card);
    the plain version on a CPU one."""
    if x.device.type == "cpu":
        return batch_norm_act_fwd_plain(x, mask, weight, bias, mult, keep, div, eps)
    _check_inputs(x, mask, weight, bias, mult, keep)
    n, c = x.shape
    y = torch.empty((n, c), dtype=x.dtype, device=x.device)
    stats = torch.empty((2 * c + 1,), dtype=torch.float32, device=x.device)
    mu, rstd, cnt = stats[:c], stats[c:2 * c], stats[2 * c:]
    n_slabs = -(-n // _SLAB_ROWS)
    part = torch.empty((n_slabs * (2 * c + 1),), dtype=torch.float32, device=x.device)
    mp, sm, mode = _mult_args(mult, keep)
    vec = _vec(c, [(x, 16), (mult, 16), (keep, 4)], [y, weight, bias, mu, rstd])
    rc = library("batch_norm_act").dgc_bn_act_fwd_f32(
        x.data_ptr(), x.stride(0), mask.data_ptr(), weight.data_ptr(), bias.data_ptr(), mp, sm,
        mode, float(div), float(eps), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        cnt.data_ptr(), part.data_ptr(), n, c, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    batch_norm_act_fwd.launches += 1
    _raise_on(rc, "K11 batch_norm_act forward")
    return y, mu, rstd, cnt


batch_norm_act_fwd.launches = 0


def batch_norm_act_bwd(dy: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor, mult: Optional[torch.Tensor],
                       keep: Optional[torch.Tensor], div: float, mu: torch.Tensor,
                       rstd: torch.Tensor, cnt: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11's backward on a CUDA tensor (dx, dw, db); the plain version on a
    CPU one."""
    if x.device.type == "cpu":
        return batch_norm_act_bwd_plain(dy, x, mask, weight, bias, mult, keep, div, mu, rstd,
                                        cnt)
    _check_inputs(x, mask, weight, bias, mult, keep)
    if dy.stride(1) != 1:
        dy = dy.contiguous()
    _check_rows("dy", dy, x, torch.float32)
    for name, a in (("mu", mu), ("rstd", rstd)):
        _check_cols(name, a, x)
    _require(cnt.device == x.device and cnt.dtype == torch.float32 and cnt.numel() == 1,
             "cnt must be a float32 tensor of one element on x's device")
    n, c = x.shape
    dx = torch.empty((n, c), dtype=x.dtype, device=x.device)
    grads = torch.empty((2 * c,), dtype=torch.float32, device=x.device)
    dw, db = grads[:c], grads[c:]
    n_slabs = -(-n // _SLAB_ROWS)
    part = torch.empty((2 * c * (n_slabs + 1),), dtype=torch.float32, device=x.device)
    mp, sm, mode = _mult_args(mult, keep)
    vec = _vec(c, [(x, 16), (dy, 16), (mult, 16), (keep, 4)], [dx, weight, bias, mu, rstd])
    rc = library("batch_norm_act").dgc_bn_act_bwd_f32(
        x.data_ptr(), x.stride(0), dy.data_ptr(), dy.stride(0), mask.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), mp, sm, mode, float(div), mu.data_ptr(),
        rstd.data_ptr(), cnt.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        part.data_ptr(), n, c, vec, torch.cuda.current_stream(x.device).cuda_stream)
    batch_norm_act_bwd.launches += 1
    _raise_on(rc, "K11 batch_norm_act backward")
    return dx, dw, db


batch_norm_act_bwd.launches = 0


# ---------------------------------------------------------------------------
# the Function
# ---------------------------------------------------------------------------

class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mask, mult, keep, div, eps, ops):
        fwd, ctx.bwd = ops
        y, mu, rstd, cnt = fwd(x, mask, weight, bias, mult, keep, div, eps)
        ctx.save_for_backward(x, weight, bias, mask, mult, keep, mu, rstd, cnt)
        ctx.div = div
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mask, mult, keep, mu, rstd, cnt = ctx.saved_tensors
        dx, dw, db = ctx.bwd(dy, x, mask, weight, bias, mult, keep, ctx.div, mu, rstd, cnt)
        return (dx, dw, db) + (None,) * 6


def _norm_act(ops, x, mask, weight, bias, mult, keep, rate, eps):
    for name, a in (("mult", mult), ("keep", keep)):
        if a is not None and a.requires_grad:
            raise ValueError(f"{name} gets no cotangent: pass it detached")
    return _BatchNormAct.apply(x, weight, bias, mask, mult, keep, 1.0 - rate, eps, ops)


def batch_norm_act(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, mult: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None, rate: float = 0.0,
                   eps: float = 1e-5) -> torch.Tensor:
    """relu(norm(x)·w + b)·mult for x [N, C] and the row mask [N]: ``mult`` a
    float tensor [N, C], or ``keep`` a bool [N, C] whose kept values are
    divided by 1 − ``rate``, or neither (see the module docstring)."""
    return _norm_act((batch_norm_act_fwd, batch_norm_act_bwd), x, mask, weight, bias, mult,
                     keep, rate, eps)


def batch_norm_act_plain(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, mult: Optional[torch.Tensor] = None,
                         keep: Optional[torch.Tensor] = None, rate: float = 0.0,
                         eps: float = 1e-5) -> torch.Tensor:
    """The same Function on the plain halves, on any device: the oracle the
    kernels are held against."""
    return _norm_act((batch_norm_act_fwd_plain, batch_norm_act_bwd_plain), x, mask, weight,
                     bias, mult, keep, rate, eps)
