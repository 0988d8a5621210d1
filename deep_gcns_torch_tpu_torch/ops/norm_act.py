"""The masked batch-statistics norm → affine → ReLU → dropout multiply as
one autograd Function (K11, `csrc/batch_norm_act.cu`), with its plain
PyTorch halves: RevGAT's block and head norms, and DeeperGCN's res+
prologues and final norm (`nn.core.BatchNorm` → ReLU → dropout, with the
running statistics, and the evaluation form).

    y = relu((x − μ)·rstd·w + b)·mult

μ and the biased variance are the column statistics over the rows whose
``mask`` is true, cnt = max(Σ mask, 1) and rstd = rsqrt(var + eps): the
masked statistics of `nn.core.InstanceNorm`, as the JAX package's
`_batch_stats_norm` (`deep_gcns_torch_tpu/models/rev_gat.py:36-43`) computes
them. ``mult`` is a float tensor (RevGAT's shared dropout-mask chunk), or
``keep``, a bool mask whose kept values are divided by ``1 − rate`` (the
inverted dropout of RevGAT's head and DeeperGCN's prologues,
`nn.core.dropout`'s arithmetic), or neither.

``running`` = (running_mean, running_var, momentum) moves a `BatchNorm`'s
running statistics in place, as `nn.core.update_running_stats` does (the
variance made unbiased by cnt / max(cnt − 1, 1)); on the card the kernels'
merge does it, with no launch of its own. The evaluation form
(`batch_norm_act_eval_fwd`) normalises by the running statistics,
y = relu((x − running_mean)·rsqrt(running_var + eps)·w + b), one launch with
no reduction; its backward is the training backward with no row in the
mask (the statistics are constants): dx = rstd·w·g.

The backward recomputes z = x̂·w + b and the ReLU gate from x, μ and rstd
(z is not saved) and, with g = dy·mult·[z > 0] over every row,

    db = Σ g,  dw = Σ g·x̂,  dx = rstd·(w·g − mask/cnt·(w·db + x̂·w·dw)):

the exact gradient of the eager chain, pad rows included (they use μ and
rstd but add nothing to them). ``mult`` and ``keep`` get no cotangent.

Dispatch is by the tensor's device, as in `ops/spmm_cuda.py`: a CPU tensor
takes the plain halves (the forward is the eager chain's arithmetic), a CUDA
tensor launches the kernels (or raises). `batch_norm_act_fwd.launches`
counts the forward kernel calls, training and evaluation, and
`batch_norm_act_bwd.launches` the backward ones. x, ``mult`` and the
cotangent may be views with a row stride (the reversible coupling's
`torch.chunk` views): the kernels read them in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..nn.core import update_running_stats
from ._build import library
from .spmm_cuda import _raise_on, _require

# kSlabRows of csrc/batch_norm_act.cu, its shorter slab: scratch sized for it
# serves a launch with the taller ones too
_SLAB_ROWS = 256

# (running_mean, running_var, momentum) of a BatchNorm in training
Running = Optional[Tuple[torch.Tensor, torch.Tensor, float]]


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
                             eps: float = 1e-5, running: Running = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, μ, rstd, cnt) by the eager chain's arithmetic; ``running`` moved
    in place."""
    m = mask[:, None].to(x.dtype)
    cnt = torch.clamp_min(m.sum(), 1.0)
    mu = (x * m).sum(0) / cnt
    var = (torch.square(x - mu) * m).sum(0) / cnt
    if running is not None:
        running_mean, running_var, momentum = running
        update_running_stats(running_mean, running_var, mu, var, cnt, momentum)
    rstd = torch.rsqrt(var + eps)
    h = torch.relu((x - mu) * rstd * weight + bias)
    return _apply_mult(h, mult, keep, div), mu, rstd, cnt


def batch_norm_act_eval_fwd_plain(x: torch.Tensor, running_mean: torch.Tensor,
                                  running_var: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, eps: float = 1e-5
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, rstd) of the evaluation form, by `BatchNorm`'s evaluation
    arithmetic followed by the ReLU."""
    rstd = torch.rsqrt(running_var + eps)
    return torch.relu((x - running_mean) * rstd * weight + bias), rstd


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


def _check_x(x):
    _require(x.device.type == "cuda", "x must be a CUDA tensor")
    _require(x.dtype == torch.float32 and x.ndim == 2 and x.stride(1) == 1,
             f"x must be a 2-D float32 tensor with column stride 1, got {x.dtype} "
             f"{tuple(x.shape)} strides {x.stride()}")


def _check_inputs(x, mask, weight, bias, mult, keep):
    _check_x(x)
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
                       keep: Optional[torch.Tensor] = None, div: float = 1.0, eps: float = 1e-5,
                       running: Running = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11's forward on a CUDA tensor (y, μ, rstd, cnt [1], all on the card;
    ``running`` moved in place by the merge); the plain version on a CPU
    one."""
    if x.device.type == "cpu":
        return batch_norm_act_fwd_plain(x, mask, weight, bias, mult, keep, div, eps, running)
    _check_inputs(x, mask, weight, bias, mult, keep)
    rm = rv = None
    momentum = 0.0
    if running is not None:
        rm, rv, momentum = running
        _check_cols("running_mean", rm, x)
        _check_cols("running_var", rv, x)
        rm, rv = rm.data_ptr(), rv.data_ptr()
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
        cnt.data_ptr(), part.data_ptr(), rm, rv, float(momentum), float(1 - momentum), n, c,
        vec, torch.cuda.current_stream(x.device).cuda_stream)
    batch_norm_act_fwd.launches += 1
    _raise_on(rc, "K11 batch_norm_act forward")
    return y, mu, rstd, cnt


batch_norm_act_fwd.launches = 0


def batch_norm_act_eval_fwd(x: torch.Tensor, running_mean: torch.Tensor,
                            running_var: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's evaluation form on a CUDA tensor (y, rstd), one launch counted
    on `batch_norm_act_fwd.launches`; the plain version on a CPU one."""
    if x.device.type == "cpu":
        return batch_norm_act_eval_fwd_plain(x, running_mean, running_var, weight, bias, eps)
    _check_x(x)
    for name, a in (("running_mean", running_mean), ("running_var", running_var),
                    ("weight", weight), ("bias", bias)):
        _check_cols(name, a, x)
    n, c = x.shape
    y = torch.empty((n, c), dtype=x.dtype, device=x.device)
    rstd = torch.empty((c,), dtype=torch.float32, device=x.device)
    vec = _vec(c, [(x, 16)], [y, running_mean, running_var, weight, bias, rstd])
    rc = library("batch_norm_act").dgc_bn_act_eval_f32(
        x.data_ptr(), x.stride(0), running_mean.data_ptr(), running_var.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), float(eps), y.data_ptr(), rstd.data_ptr(), n, c, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    batch_norm_act_fwd.launches += 1
    _raise_on(rc, "K11 batch_norm_act evaluation")
    return y, rstd


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
    def forward(ctx, x, weight, bias, mask, mult, keep, div, eps, ops, running):
        fwd, ctx.bwd = ops
        y, mu, rstd, cnt = fwd(x, mask, weight, bias, mult, keep, div, eps, running)
        ctx.save_for_backward(x, weight, bias, mask, mult, keep, mu, rstd, cnt)
        ctx.div = div
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mask, mult, keep, mu, rstd, cnt = ctx.saved_tensors
        dx, dw, db = ctx.bwd(dy, x, mask, weight, bias, mult, keep, ctx.div, mu, rstd, cnt)
        return (dx, dw, db) + (None,) * 7


class _BatchNormActEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, ops):
        fwd, ctx.bwd = ops
        y, rstd = fwd(x, running_mean, running_var, weight, bias, eps)
        ctx.save_for_backward(x, weight, bias, running_mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mu, rstd = ctx.saved_tensors
        no_rows = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
        cnt = torch.ones((1,), dtype=torch.float32, device=x.device)
        dx, dw, db = ctx.bwd(dy, x, no_rows, weight, bias, None, None, 1.0, mu, rstd, cnt)
        return (dx, dw, db) + (None,) * 4


def _norm_act(ops, x, mask, weight, bias, mult, keep, rate, eps, running):
    for name, a in (("mult", mult), ("keep", keep)):
        if a is not None and a.requires_grad:
            raise ValueError(f"{name} gets no cotangent: pass it detached")
    return _BatchNormAct.apply(x, weight, bias, mask, mult, keep, 1.0 - rate, eps, ops, running)


def batch_norm_act(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, mult: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None, rate: float = 0.0,
                   eps: float = 1e-5, running: Running = None) -> torch.Tensor:
    """relu(norm(x)·w + b)·mult for x [N, C] and the row mask [N]: ``mult`` a
    float tensor [N, C], or ``keep`` a bool [N, C] whose kept values are
    divided by 1 − ``rate``, or neither; ``running`` (running_mean,
    running_var, momentum) moved in place (see the module docstring)."""
    return _norm_act((batch_norm_act_fwd, batch_norm_act_bwd), x, mask, weight, bias, mult,
                     keep, rate, eps, running)


def batch_norm_act_plain(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, mult: Optional[torch.Tensor] = None,
                         keep: Optional[torch.Tensor] = None, rate: float = 0.0,
                         eps: float = 1e-5, running: Running = None) -> torch.Tensor:
    """The same Function on the plain halves, on any device: the oracle the
    kernels are held against."""
    return _norm_act((batch_norm_act_fwd_plain, batch_norm_act_bwd_plain), x, mask, weight,
                     bias, mult, keep, rate, eps, running)


def _norm_act_eval(ops, x, running_mean, running_var, weight, bias, eps):
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias))):
        return ops[0](x, running_mean, running_var, weight, bias, eps)[0]
    # the mean saved as a copy: a later training forward moves it in place
    return _BatchNormActEval.apply(x, weight, bias, running_mean.clone(), running_var, eps, ops)


def batch_norm_act_eval(x: torch.Tensor, running_mean: torch.Tensor,
                        running_var: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """relu((x − running_mean)·rsqrt(running_var + eps)·w + b), the
    evaluation form; through autograd only where a gradient is wanted."""
    return _norm_act_eval((batch_norm_act_eval_fwd, batch_norm_act_bwd), x, running_mean,
                          running_var, weight, bias, eps)


def batch_norm_act_eval_plain(x: torch.Tensor, running_mean: torch.Tensor,
                              running_var: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The evaluation form on the plain halves."""
    return _norm_act_eval((batch_norm_act_eval_fwd_plain, batch_norm_act_bwd_plain), x,
                          running_mean, running_var, weight, bias, eps)
