"""GENConv's softmax aggregation shifted per receiver, against a float64
per-receiver softmax written out here (the reference's `scatter_softmax`,
stop-gradient weights for softmax_sg), on a graph where channel 0's scores
spread far past float32's exp range: a hub receiver fed by senders of every
size, one of them at ~2,000, and a receiver whose senders are all small. One
global shift a channel, as the JAX package takes it, leaves every weight of
the second receiver at 0 there, so its aggregation would come out 0.

The plain versions of K2 and K4 on the CPU: the fused Function without and
with edge embeddings and K2's message form, softmax_sg and learn_t; forward,
dx (or d(msgs)), d(ee) and dt, and `gradcheck` of the same Functions in
float64. The kernels on the card against the same float64 reference are
marked ``cuda``; the file imports no JAX, so they run with

    pytest --noconftest -m cuda tests/test_torch_softmax_shift.py
"""

import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
from torch_budget import budget  # noqa: F401

EPS = 1e-7
T = float(np.float32(0.1))  # ResGEN-28's t, as the float32 the Functions read
HUB, QUIET = 10, 11         # the receiver fed by every sender, and the one fed by small ones
FORMS = ["gather", "ee", "msgs"]
# float32 against float64: scores up to ~200 carry float32 rounding of up to
# 8e-6, so each weight carries ~1e-5 relative error; sums of a few dozen
# terms add ~1e-6. Gradients sum such terms with mixed signs, so they are
# held at 1e-4 relative above a floor of 1e-5 of their largest value.
FWD = dict(rtol=2e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
# dt = Σ g·a·m·(m − out) cancels to a variance: the float32 rounding of out
# (~2^-23 of it) enters multiplied by m ≈ out, so dt is held to 1e-6 of
# Σ |g|·out² (channel 0's 2,000² makes that ~3 against readings of ~0.6)
DT_ATOL_REL = 1e-6


def spread_graph(n=64, c=6, seed=0, **pad):
    """(graph with 8-dim edge features, x [N_pad, C]): random edges, self
    loops, every node sending to HUB, and QUIET fed by nodes 20..29 alone.
    Channel 0 of nodes 0..7 sits near 2,000 (scores near 200 at t = 0.1),
    every other value is standard normal."""
    rng = np.random.default_rng(seed)
    s = [rng.integers(0, n, 4 * n), np.arange(n), np.arange(n), np.arange(20, 30)]
    r = [rng.integers(30, n, 4 * n), np.arange(n), np.full(n, HUB), np.full(10, QUIET)]
    s, r = np.concatenate(s), np.concatenate(r)
    keep = (r != QUIET) | ((s >= 20) & (s < 30))
    s, r = s[keep], r[keep]
    x = rng.standard_normal((n, c)).astype(np.float32)
    x[:8, 0] = 2000.0 + 50.0 * rng.random(8).astype(np.float32)
    ea = rng.random((s.shape[0], 8)).astype(np.float32)
    g = build_graph(x, s, r, edge_attr=ea, num_nodes=n, **pad)
    return g, g.x


def _edge_tables(g, c, dtype, seed=1):
    """Edge embeddings in both edge orders (a Linear of the edge features)."""
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((8, c)).astype(np.float32))
    w = w.to(g.edge_attr.device)
    return (g.edge_attr @ w * 0.5).to(dtype), (g.edge_attr_csc @ w * 0.5).to(dtype)


def reference(m, recv, n, t, grad_weights):
    """out [n, C] of the per-receiver softmax aggregation of messages m [E, C]
    in float64: weights softmax over each receiver's edges of t·m, shifted
    by the receiver's own maximum, detached unless ``grad_weights``."""
    s = t * m
    idx = recv[:, None].expand_as(s)
    top = torch.full((n, m.shape[1]), float("-inf"), dtype=m.dtype).scatter_reduce(
        0, idx, s.detach(), "amax")
    w = torch.exp(s - top[recv])
    den = torch.zeros((n, m.shape[1]), dtype=m.dtype).index_add(0, recv, w)
    a = w / den[recv]
    if not grad_weights:
        a = a.detach()
    return torch.zeros((n, m.shape[1]), dtype=m.dtype).index_add(0, recv, a * m)


def _run(form, g, x, grad_weights, fns, dtype=torch.float32):
    """(out, {name: gradient}) of the port under the cotangent co, with the
    inputs in ``dtype``, and the float64 reference's, over the valid edges
    in receiver order; d(ee) is mapped back from sender order."""
    fused, msgs_fn = fns
    dev = g.senders.device
    n_pad, ne, c = g.num_nodes_padded, g.n_edge, x.shape[1]
    co = torch.from_numpy(np.random.default_rng(5).standard_normal((n_pad, c))
                          .astype(np.float32)).to(dev)
    s, r = g.senders[:ne].long(), g.receivers[:ne].long()
    t = torch.tensor([T], device=dev, requires_grad=grad_weights)
    xx = x.to(dtype).detach().clone().requires_grad_(True)
    ee, ee_csc = _edge_tables(g, c, dtype) if form == "ee" else (None, None)
    grads = {}
    if form == "msgs":
        mm = (torch.relu(xx.detach().float()[g.senders.long().clamp(max=n_pad - 1)]) + EPS)
        mm = mm.to(dtype).requires_grad_(True)
        out = msgs_fn(mm, g.receivers, g.row_ptr, t, grad_weights)
        (out.float() * co).sum().backward()
        grads["dm"] = mm.grad[:ne]
    else:
        ec = None if ee_csc is None else ee_csc.detach().clone().requires_grad_(True)
        out = fused(xx, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr,
                    g.csc_order, t, ee=ee, ee_csc=ec, eps=EPS, grad_weights=grad_weights)
        (out.float() * co).sum().backward()
        grads["dx"] = xx.grad
        if ec is not None:
            dee = torch.zeros_like(ec.grad[:ne])
            dee[g.csc_perm[:ne].long()] = ec.grad[:ne]
            grads["dee"] = dee
            assert not ec.grad[ne:].any()
    if grad_weights:
        grads["dt"] = t.grad
    # the float64 reference on the same values
    x64 = xx.detach().double().cpu().requires_grad_(True)
    t64 = torch.tensor([T], dtype=torch.float64, requires_grad=grad_weights)
    s, r, co64 = s.cpu(), r.cpu(), co.double().cpu()
    want = {}
    if form == "msgs":
        m64 = mm.detach()[:ne].double().cpu().requires_grad_(True)
        ref = reference(m64, r, n_pad, t64, grad_weights)
        (ref * co64).sum().backward()
        want["dm"] = m64.grad
    else:
        xj = x64[s]
        e64 = None
        if ee is not None:
            e64 = ee[:ne].double().cpu().requires_grad_(True)
            xj = xj + e64
        ref = reference(torch.relu(xj) + EPS, r, n_pad, t64, grad_weights)
        (ref * co64).sum().backward()
        want["dx"] = x64.grad
        if e64 is not None:
            want["dee"] = e64.grad
    if grad_weights:
        want["dt"] = t64.grad
    return out.detach().double().cpu(), ref.detach(), \
        {k: v.double().cpu() for k, v in grads.items()}, want, co64


def _check(out, ref, grads, want, co):
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FWD)
    assert set(grads) == set(want)
    for k in grads:
        w = want[k].numpy()
        atol = GRAD_ATOL_REL * float(np.abs(w).max())
        if k == "dt":
            atol = DT_ATOL_REL * float((co.abs() * ref ** 2).sum())
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=GRAD_RTOL, atol=atol, err_msg=k)


def test_one_global_shift_would_underflow_here():
    """The case is past the threshold: under one shift a channel (t times
    the largest message) every weight of QUIET's edges is 0 in float32, and
    channel 0 of HUB's small senders as well."""
    g, x = spread_graph()
    m = torch.relu(x) + EPS
    top = (T * m.max(0).values).float()
    lo, hi = int(g.row_ptr[QUIET]), int(g.row_ptr[QUIET + 1])
    assert hi - lo == 10
    w = torch.exp(T * m[g.senders[lo:hi].long(), 0] - top[0])
    assert not w.any()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("grad_weights", [False, True])
def test_plain_shift_matches_float64(form, grad_weights):
    """The plain Functions against the float64 per-receiver softmax: out,
    d(x or msgs), d(ee) and dt; QUIET's aggregation is its own softmax, not
    0."""
    g, x = spread_graph()
    fns = (tsp.fused_softmax_gather_agg_plain, tsp.gen_softmax_aggregate_csr_plain)
    out, ref, grads, want, co = _run(form, g, x, grad_weights, fns)
    _check(out, ref, grads, want, co)
    assert (out[QUIET].abs() > 1e-3).all() and (out[HUB, 0] > 1000)


@pytest.mark.parametrize("form", FORMS)
def test_plain_shift_gradcheck(form):
    """`gradcheck` (fast mode) of the plain Functions in float64 on a small
    spread graph (channel 0 near 2,000 on two senders), with learned t: the
    whole derivative, weights included (softmax_sg's stop-gradient weights
    are by design not the derivative of its forward; the float64 reference
    above holds them)."""
    grad_weights = True
    g, _ = spread_graph(n=40, c=3, seed=2, pad_multiple=8, edge_pad_multiple=64)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((g.num_nodes_padded, 3))).double()
    x[:2, 0] = 2000.0 + torch.rand(2, dtype=torch.float64)
    x.requires_grad_(True)
    t = torch.tensor([T], dtype=torch.float64, requires_grad=grad_weights)
    ne, n_pad = g.n_edge, g.num_nodes_padded
    if form == "msgs":
        m = (torch.relu(x.detach()[g.senders.long().clamp(max=n_pad - 1)]) + EPS)
        m.requires_grad_(True)
        fn = lambda m_, t_: tsp.gen_softmax_aggregate_csr_plain(  # noqa: E731
            m_, g.receivers, g.row_ptr, t_, grad_weights)
        inputs = (m, t)
    elif form == "gather":
        fn = lambda x_, t_: tsp.fused_softmax_gather_agg_plain(  # noqa: E731
            x_, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr, g.csc_order,
            t_, eps=EPS, grad_weights=grad_weights)
        inputs = (x, t)
    else:
        _, ee_csc = _edge_tables(g, 3, torch.float64)
        ee_csc = ee_csc.detach().requires_grad_(True)
        perm = g.csc_perm[:ne].long()

        def fn(x_, e_csc, t_):
            ee = torch.zeros_like(e_csc).index_copy(0, perm, e_csc[:ne])
            return tsp.fused_softmax_gather_agg_plain(
                x_, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr,
                g.csc_order, t_, ee=ee, ee_csc=e_csc, eps=EPS, grad_weights=grad_weights)
        inputs = (x, ee_csc, t)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6, rtol=1e-4, fast_mode=True)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("grad_weights", [False, True])
def test_kernels_shift_match_float64(form, grad_weights):
    """The kernels (K2 in its three modes, K4's gather and `ee` forms) on the
    card against the float64 reference, in float32, with the plain
    versions' tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run `pytest --noconftest -m cuda "
                    "tests/test_torch_softmax_shift.py` on the card)")
    g, x = spread_graph()
    g = g.to(torch.device("cuda"))
    fns = (tsp.fused_softmax_gather_agg, tsp.gen_softmax_aggregate_csr)
    before = (tsp.softmax_agg.launches, tsp.softmax_agg.launches_ee,
              tsp.softmax_agg_msgs.launches, tsp.softmax_bwd_csc.launches)
    out, ref, grads, want, co = _run(form, g, g.x, grad_weights, fns)
    torch.cuda.synchronize()
    _check(out, ref, grads, want, co)
    after = (tsp.softmax_agg.launches, tsp.softmax_agg.launches_ee,
             tsp.softmax_agg_msgs.launches, tsp.softmax_bwd_csc.launches)
    want_launches = {"gather": (1, 0, 0, 1), "ee": (0, 1, 0, 1), "msgs": (0, 0, 1, 0)}[form]
    assert tuple(a - b for a, b in zip(after, before)) == want_launches
