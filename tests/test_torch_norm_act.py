"""RevGAT's fused norm → ReLU → dropout multiply (`ops/norm_act.py`) on the
CPU: the Function's plain halves against `torch.autograd` of the eager chain
(`InstanceNorm`'s masked statistics, the affine, ReLU, then the multiply),
in float64, with pad rows, no valid row at all (cnt clamped to 1), strided
chunk views of x and the multiplier, and all three multiplier forms. The
kernels (K11) are held against these halves on the card, in
tests/test_torch_cuda.py."""

import pytest
import torch

from deep_gcns_torch_tpu_torch.models.rev_gat import BatchStatsNorm
from deep_gcns_torch_tpu_torch.nn.core import InstanceNorm
from deep_gcns_torch_tpu_torch.ops import norm_act as tna
from torch_budget import budget  # noqa: F401

N, C = 37, 6
MULTS = ["float", "keep", "none"]


def _inputs(dtype, mult_form, n_valid, strided, seed=0):
    """x [N, C] (a chunk view of a [N, 2C] tensor when ``strided``), the row
    mask with ``n_valid`` leading valid rows, weight, bias, and the
    multiplier: a float mask chunk (values 0 or 1/(1 − 0.4)), a bool keep,
    or none. The residual stream's large column means are in x."""
    gen = torch.Generator().manual_seed(seed)
    wide = torch.randn(N, 2 * C, generator=gen, dtype=dtype) * 3.0 + 20.0
    x = torch.chunk(wide, 2, dim=-1)[1] if strided else wide[:, :C].clone()
    mask = torch.arange(N) < n_valid
    w = torch.rand(C, generator=gen, dtype=dtype) + 0.5
    b = torch.randn(C, generator=gen, dtype=dtype) * 0.5
    keep_wide = torch.rand(N, 2 * C, generator=gen) >= 0.4
    mult = keep = None
    if mult_form == "float":
        m = keep_wide.to(dtype) / (1.0 - 0.4)
        mult = torch.chunk(m, 2, dim=-1)[1] if strided else m[:, :C].clone()
    elif mult_form == "keep":
        keep = keep_wide[:, :C].contiguous()
    return x, mask, w, b, mult, keep


def _eager(x, mask, w, b, mult, keep, rate):
    """The chain as RevGAT ran it before the fused Function."""
    h = torch.relu(InstanceNorm(x.shape[1])(x, mask) * w + b)
    if mult is not None:
        return h * mult
    if keep is not None:
        return torch.where(keep, h / (1.0 - rate), torch.zeros((), dtype=h.dtype))
    return h


@pytest.mark.parametrize("mult_form", MULTS)
@pytest.mark.parametrize("n_valid", [30, 0])
@pytest.mark.parametrize("strided", [True, False])
def test_plain_function_gradcheck(mult_form, n_valid, strided):
    """float64 `gradcheck` of the Function on its plain halves: x, weight
    and bias, pad rows (mask false) and, with ``n_valid`` 0, cnt clamped."""
    x, mask, w, b, mult, keep = _inputs(torch.float64, mult_form, n_valid, strided)
    x = x.detach().requires_grad_(True)
    w, b = w.requires_grad_(True), b.requires_grad_(True)

    def fn(x_, w_, b_):
        return tna.batch_norm_act_plain(x_, mask, w_, b_, mult=mult, keep=keep, rate=0.4)

    assert torch.autograd.gradcheck(fn, (x, w, b), eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("mult_form", MULTS)
@pytest.mark.parametrize("n_valid", [30, 0])
@pytest.mark.parametrize("strided", [True, False])
def test_plain_function_matches_eager_autograd(mult_form, n_valid, strided):
    """Output and every cotangent against autograd of the eager chain in
    float64 (1e-12 relative: the two backwards sum in different orders)."""
    res = []
    for fn in (lambda *a: tna.batch_norm_act(*a[:4], mult=a[4], keep=a[5], rate=0.4),
               lambda *a: _eager(*a, rate=0.4)):
        x, mask, w, b, mult, keep = _inputs(torch.float64, mult_form, n_valid, strided)
        x = x.detach().requires_grad_(True)
        w, b = w.requires_grad_(True), b.requires_grad_(True)
        y = fn(x, mask, w, b, mult, keep)
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(9), dtype=y.dtype)
        y.backward(dy)
        res.append((y.detach(), x.grad, w.grad, b.grad))
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("mult_form", MULTS)
@pytest.mark.parametrize("strided", [True, False])
def test_plain_forward_is_the_eager_chain_bit_for_bit(mult_form, strided):
    """float32: the CPU forward is the eager chain's arithmetic, so the
    port's CPU results (and its parity with JAX) keep their bits."""
    x, mask, w, b, mult, keep = _inputs(torch.float32, mult_form, 30, strided)
    got = tna.batch_norm_act(x, mask, w, b, mult=mult, keep=keep, rate=0.4)
    assert torch.equal(got, _eager(x, mask, w, b, mult, keep, 0.4))


def test_plain_halves_take_views_without_copies():
    """The plain halves read the strided chunk views as they are; the
    Function saves x itself (no contiguous copy)."""
    x, mask, w, b, mult, _ = _inputs(torch.float32, "float", 30, True)
    assert not x.is_contiguous() and not mult.is_contiguous()
    x = x.detach().requires_grad_(True)
    y = tna.batch_norm_act(x, mask, w, b, mult=mult)
    saved = y.grad_fn.saved_tensors
    assert saved[0].data_ptr() == x.data_ptr() and saved[0].stride() == x.stride()


@pytest.mark.parametrize("which", ["mult", "keep"])
def test_multiplier_with_grad_is_refused(which):
    x, mask, w, b, mult, keep = _inputs(torch.float32, "float" if which == "mult" else "keep",
                                        30, False)
    if which == "mult":
        mult = mult.requires_grad_(True)
        with pytest.raises(ValueError, match="no cotangent"):
            tna.batch_norm_act(x, mask, w, b, mult=mult)
    else:
        keep = keep.float().requires_grad_(True)
        with pytest.raises(ValueError, match="no cotangent"):
            tna.batch_norm_act(x, mask, w, b, keep=keep, rate=0.4)


def test_cpu_tensors_launch_no_kernel():
    """A CPU tensor takes the plain halves: the kernel counters stay."""
    f0, b0 = tna.batch_norm_act_fwd.launches, tna.batch_norm_act_bwd.launches
    x, mask, w, b, mult, _ = _inputs(torch.float32, "float", 30, True)
    x = x.detach().requires_grad_(True)
    tna.batch_norm_act(x, mask, w, b, mult=mult).sum().backward()
    assert (tna.batch_norm_act_fwd.launches, tna.batch_norm_act_bwd.launches) == (f0, b0)


def test_batch_stats_norm_keeps_its_parameter_names():
    """`norm.weight` and `norm.bias`, and no buffers, as checkpoints and the
    reference's import expect."""
    m = BatchStatsNorm(C)
    assert sorted(m.state_dict()) == ["bias", "weight"]
    assert torch.equal(m.weight, torch.ones(C)) and torch.equal(m.bias, torch.zeros(C))
