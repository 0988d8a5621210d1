"""The port's sparse conv zoo, GENConv's route gate, K2's message form and
`band_extreme` against the JAX package on the CPU, on numpy inputs from a
seed.

* GENConv on graphs without their CSC (and without ``row_ptr``): the JAX
  package gates its fused route on `fused_gather_ok` and falls to the
  unfused branch; so must the port (output and every gradient).
* `generalized_aggregate` with ``row_ptr`` for every aggregator against
  JAX's XLA route, and the softmax family against JAX's kernel route
  (`spmm_pallas.gen_softmax_aggregate_csr` in interpret mode).
* Each zoo conv (edge, mr, gat, gcn, gin, sage, rsage) forward and every
  gradient, with batch norm (EdgeConv's over the valid edges), on graphs
  without a band and, for the convs with a band route, with one (the JAX
  convs under `ops.band._TEST_MODE`, as tests/test_band_convs.py runs them);
  GENConv max/min on a band (`band_extreme`); the six conv goldens loaded
  through the reference's names.

Tolerances: both sides run in float32 and differ in the order of their sums
(forward 2e-4, the conv goldens' 5e-4 / 5e-5 of
tests/test_reference_goldens.py); gradients rtol 1e-3 with a floor of 1e-5
of the largest gradient (a bias feeding a BatchNorm has a true gradient of
0, and what both return for it is rounding noise). bf16: one bf16 ulp on the
output, and the rel-l2 bound of tests/test_spmm_pallas.py::
test_bf16_den_backward_close_to_f32 (1.5e-2) on the gradient.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import deep_gcns_torch_tpu.convs.sparse as jcs
import deep_gcns_torch_tpu.ops.band as jband
from deep_gcns_torch_tpu.graph import attach_band as jax_attach_band
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.ops import segment as jseg
from deep_gcns_torch_tpu.ops import spmm_pallas as sp
import deep_gcns_torch_tpu_torch.convs.sparse as tcs
from deep_gcns_torch_tpu_torch.graph import attach_band, build_graph
from deep_gcns_torch_tpu_torch.ops import band as tband
from deep_gcns_torch_tpu_torch.ops import segment as tseg
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
from deep_gcns_torch_tpu_torch.utils.import_jax import _genconv, zoo_conv_entries
from deep_gcns_torch_tpu_torch.utils.import_torch import import_deepgcn
from torch_budget import budget  # noqa: F401

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
FWD = dict(rtol=2e-4, atol=2e-4)
AGG = dict(rtol=2e-5, atol=2e-5)
AGG_GRAD = dict(rtol=5e-4, atol=1e-5)
AGGRS = ("softmax", "softmax_sg", "softmax_sum", "power", "power_sum", "add", "mean",
         "max", "min")
CONVS = ("edge", "mr", "gat", "gcn", "gin", "sage", "rsage")
BAND_CONVS = ("mr", "gcn", "gin", "sage", "rsage")


@pytest.fixture
def band_mode():
    jband._TEST_MODE = True
    yield
    jband._TEST_MODE = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(seed, n=200, deg=6, c=16, band=False, **kw):
    """The same graph on both sides: random edges, or (``band``) edges
    within ±40 of their sender plus 1 % random ones, with its hub-free band
    attached (window 256, the leftover non-empty)."""
    rng = np.random.default_rng(seed)
    e = n * deg
    s = rng.integers(0, n, e)
    if band:
        r = np.clip(s + rng.integers(-40, 41, e), 0, n - 1)
        cross = rng.random(e) < 0.01
        r[cross] = rng.integers(0, n, int(cross.sum()))
    else:
        r = rng.integers(0, n, e)
    x = rng.standard_normal((n, c)).astype(np.float32)
    gt = build_graph(x, s, r, num_nodes=n, **kw)
    gj = jax_build_graph(x, s, r, num_nodes=n, **kw)
    if band:
        gt, gj = attach_band(gt, 256, None), jax_attach_band(gj, 256, None)
        assert gt.band.fwd.n_lo > 0 and tband.band_extreme_ok(gt)
    return gt, gj, rng


def _check_grads(named, want, g_max=None):
    """Every parameter's gradient against the mapped JAX gradient."""
    assert set(named) <= set(want), sorted(set(named) - set(want))
    if g_max is None:
        g_max = max(float(np.abs(want[k].numpy()).max()) for k in named)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), err_msg=k, rtol=1e-3,
                                   atol=1e-5 * g_max)


# ---------------------------------------------------------------------------
# GENConv's route gate (the unfused branch without CSC / row_ptr)
# ---------------------------------------------------------------------------

def _genconv_pair(aggr, learn_t, c=16, seed=0):
    kw = dict(aggr=aggr, t=0.8, learn_t=learn_t, learn_y=aggr == "softmax_sum", y=0.3,
              norm="batch", mlp_layers=2)
    jconv = jcs.GENConv(c, c, **kw)
    params, state = jax.jit(jconv.init)(jax.random.PRNGKey(seed))
    holder = nn.Module()
    holder.conv = tcs.GENConv(c, c, **kw)
    cfg = SimpleNamespace(mlp_layers=2, learn_t=learn_t, aggr=aggr, learn_p=False,
                          learn_y=kw["learn_y"])
    return jconv, params, state, holder, cfg


def _genconv_matches_jax(gt, gj, rng, aggr, learn_t):
    """The port's GENConv on ``gt`` against JAX's on ``gj`` (the same graph)
    from the same weights: output, the input's and every parameter's
    gradient."""
    jconv, params, state, holder, cfg = _genconv_pair(aggr, learn_t)
    co = rng.standard_normal((gt.num_nodes_padded, 16)).astype(np.float32)
    x = np.asarray(gj.x)

    def loss_j(p, x_):
        out, ns = jconv.apply(p, state, x_, gj, train=True)
        return jnp.sum(out * co), (out, ns)

    (_, (want, _)), (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    sd = {}
    _genconv(sd, "conv", _np_tree(params), _np_tree(state), cfg, "batch", ())
    holder.load_state_dict(sd, strict=False)
    holder.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = holder.conv(xt, gt)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3, atol=1e-5)
    want_g = {}
    _genconv(want_g, "conv", _np_tree(gp), _np_tree(state), cfg, "batch", ())
    _check_grads(dict(holder.named_parameters()), want_g)


@pytest.mark.parametrize("aux", ["no_csc", "no_csc_no_row_ptr"])
@pytest.mark.parametrize("aggr,learn_t", [("softmax_sg", False), ("softmax", True),
                                          ("softmax_sum", True)])
def test_genconv_without_csc_matches_jax(aux, aggr, learn_t):
    """A graph without its CSC auxiliaries (and without ``row_ptr``) takes
    the unfused branch on both sides: gather, relu + ε, then
    `generalized_aggregate` (with ``row_ptr``: K2's message form, its plain
    version here; without: the segment softmax)."""
    kw = dict(with_csc=False) if aux == "no_csc" else dict(with_csc=False, with_row_ptr=False)
    gt, gj, rng = _graphs(1, **kw)
    assert gt.csc_col_ptr is None and (aux == "no_csc") == (gt.row_ptr is not None)
    _genconv_matches_jax(gt, gj, rng, aggr, learn_t)


@pytest.mark.parametrize("with_csc", [True, False])
def test_genconv_unaligned_padding_takes_kernel_routes(with_csc, monkeypatch):
    """Padding that is no multiple of JAX's tiles (N_pad 200, E_pad 1300)
    turns no route away: with CSC the fused route runs, without it K2's
    message form (their plain versions here), the only miss counted is the
    missing CSC's, and the result is JAX's (its XLA route on the CPU)."""
    gt, gj, rng = _graphs(2, node_pad=200, edge_pad=1300, with_csc=with_csc)
    assert (gt.num_nodes_padded, gt.num_edges_padded) == (200, 1300)
    calls = []
    for mod, name in ((tcs, "fused_softmax_gather_agg_auto"),
                      (tseg, "gen_softmax_aggregate_csr")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, _f=orig, **k: calls.append(_n) or _f(*a, **k))
    misses = tseg.fastpath_misses()
    _genconv_matches_jax(gt, gj, rng, "softmax", True)
    assert calls == ["fused_softmax_gather_agg_auto" if with_csc
                     else "gen_softmax_aggregate_csr"]
    missed = {k: v - misses.get(k, 0) for k, v in tseg.fastpath_misses().items()
              if v != misses.get(k, 0)}
    assert missed == ({} if with_csc else {"fused_gather_agg:graph lacks CSR/CSC aux indices": 1})


# ---------------------------------------------------------------------------
# generalized_aggregate's kernel routes and K2's message form
# ---------------------------------------------------------------------------

def _edges(seed, n=60, e=400, c=6):
    rng = np.random.default_rng(seed)
    g = jax_build_graph(None, rng.integers(0, n, e), rng.integers(0, n, e), num_nodes=n,
                        node_pad=128, edge_pad=512)
    msgs = np.abs(rng.standard_normal((g.num_edges_padded, c))).astype(np.float32) + 1e-3
    co = rng.standard_normal((g.num_nodes_padded, c)).astype(np.float32)
    return g, msgs, co


@pytest.mark.parametrize("aggr", AGGRS)
def test_generalized_aggregate_with_row_ptr_matches_jax(aggr):
    """With ``row_ptr`` the port takes its kernel routes (K1 for the sum
    family, K2's message form for the softmax family; their plain versions
    here) and max/min/power their segment reductions; JAX on the CPU takes
    its XLA route. Forward and the gradients of the messages, t, p and y."""
    learn_t = aggr in ("softmax", "softmax_sum")
    g, msgs, co = _edges(1)
    recv, mask, n_pad = np.asarray(g.receivers), np.asarray(g.edge_mask), g.num_nodes_padded
    scal = {"t": np.float32(1.3), "p": np.float32(1.7), "y": np.float32(0.4)}

    def f_jax(m, t, p, y):
        out = jseg.generalized_aggregate(m, jnp.asarray(recv), n_pad, aggr=aggr, t=t, p=p,
                                         y=y, learn_t=learn_t, mask=jnp.asarray(mask))
        return jnp.sum(out * co), out

    (_, want), grads = jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(msgs), *(jnp.asarray(v) for v in scal.values()))
    m_t = torch.from_numpy(msgs).requires_grad_(True)
    sc_t = {k: torch.tensor([v], requires_grad=True) for k, v in scal.items()}
    got = tseg.generalized_aggregate(m_t, torch.from_numpy(recv), n_pad, aggr=aggr,
                                     learn_t=learn_t, mask=torch.from_numpy(mask),
                                     row_ptr=torch.from_numpy(np.asarray(g.row_ptr)), **sc_t)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **AGG)
    np.testing.assert_allclose(m_t.grad.numpy(), np.asarray(grads[0]), **AGG_GRAD)
    for (k, v), gj in zip(sc_t.items(), grads[1:]):
        gt = 0.0 if v.grad is None else float(v.grad[0])
        np.testing.assert_allclose(gt, float(gj), err_msg=k, **AGG_GRAD)


@pytest.mark.parametrize("name", ["add", "mean", "max"])
@pytest.mark.parametrize("c,node_pad", [(40, 128), (6, 128), (40, 192)])
def test_scatter_with_row_ptr_matches_jax(name, c, node_pad, monkeypatch):
    """`scatter` given ``row_ptr``: sum and mean through K1 (its plain version
    here) when the flat width is at least 32, at any padding (N_pad of 192
    is not a multiple of JAX's 128-row tile; K1 needs none), the scatter
    path for narrower rows; no miss is counted; max never reads
    ``row_ptr``. Masked entries inside the CSR ranges contribute nothing;
    forward and gradient against JAX's `scatter` (its XLA route on the
    CPU)."""
    rng = np.random.default_rng(7)
    n, e = 100, 700
    g = jax_build_graph(None, rng.integers(0, n, e), rng.integers(0, n, e), num_nodes=n,
                        node_pad=node_pad, edge_pad=1024)
    data = rng.standard_normal((g.num_edges_padded, c)).astype(np.float32)
    mask = np.asarray(g.edge_mask) & (rng.random(g.num_edges_padded) < 0.8)
    co = rng.standard_normal((node_pad, c)).astype(np.float32)
    recv, rp = np.asarray(g.receivers), np.asarray(g.row_ptr)

    def f(d):
        out = jseg.scatter(name, d, jnp.asarray(recv), node_pad, jnp.asarray(mask))
        return jnp.sum(out * co), out

    (_, want), gwant = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(data))
    calls = []
    monkeypatch.setattr(tseg, "segment_sum_csr",
                        lambda *a: calls.append(1) or tsp.segment_sum_csr(*a))
    misses = tseg.fastpath_misses()
    d_t = torch.from_numpy(data).requires_grad_(True)
    got = tseg.scatter(name, d_t, torch.from_numpy(recv), node_pad, torch.from_numpy(mask),
                       row_ptr=torch.from_numpy(rp))
    (got * torch.from_numpy(co)).sum().backward()
    assert calls == ([1] if name != "max" and c >= 32 else [])
    assert tseg.fastpath_misses() == misses
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **AGG)
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(gwant), **AGG_GRAD)


@pytest.mark.parametrize("aggr", ["softmax_sg", "softmax", "softmax_sum"])
def test_message_form_matches_jax_kernel_route(aggr, monkeypatch):
    """`generalized_aggregate` with ``row_ptr`` against JAX's kernel route
    (`use_pallas=True`, its `gen_softmax_aggregate_csr` in interpret mode):
    the same exact shift, the same per-term roundings and the same backward
    (learned t for softmax and softmax_sum, learned y for softmax_sum)."""
    orig = sp.gen_softmax_aggregate_csr
    monkeypatch.setattr(sp, "gen_softmax_aggregate_csr",
                        lambda m, r, rp, t, gw: orig(m, r, rp, t, gw, True))
    learn_t = aggr != "softmax_sg"
    g, msgs, co = _edges(2, c=24)
    msgs = msgs - 0.5  # messages of either sign: the shift takes the max of t·m
    recv, rp, n_pad = np.asarray(g.receivers), np.asarray(g.row_ptr), g.num_nodes_padded

    def f_jax(m, t, y):
        out = jseg.generalized_aggregate(m, jnp.asarray(recv), n_pad, aggr=aggr, t=t, y=y,
                                         learn_t=learn_t, mask=jnp.asarray(g.edge_mask),
                                         row_ptr=jnp.asarray(rp), use_pallas=True)
        return jnp.sum(out * co), out

    args = (jnp.asarray(msgs), jnp.asarray([-0.9], jnp.float32), jnp.asarray([0.4]))
    (_, want), grads = jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1, 2), has_aux=True))(*args)
    m_t = torch.from_numpy(msgs).requires_grad_(True)
    t_t = torch.tensor([-0.9], requires_grad=True)
    y_t = torch.tensor([0.4], requires_grad=True)
    calls = []
    monkeypatch.setattr(tseg, "gen_softmax_aggregate_csr",
                        lambda *a: calls.append(1) or tsp.gen_softmax_aggregate_csr(*a))
    got = tseg.generalized_aggregate(m_t, torch.from_numpy(recv), n_pad, aggr=aggr, t=t_t,
                                     y=y_t, learn_t=learn_t,
                                     mask=torch.from_numpy(np.asarray(g.edge_mask)),
                                     row_ptr=torch.from_numpy(rp))
    (got * torch.from_numpy(co)).sum().backward()
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **AGG)
    np.testing.assert_allclose(m_t.grad.numpy(), np.asarray(grads[0]), **AGG_GRAD)
    for v, gj in ((t_t, grads[1]), (y_t, grads[2])):
        gt = np.zeros(1, np.float32) if v.grad is None else v.grad.numpy()
        np.testing.assert_allclose(gt, np.asarray(gj), **AGG_GRAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_weights", [False, True])
def test_message_form_function_matches_jax(dtype, grad_weights):
    """`gen_softmax_aggregate_csr` (the plain K2 message form and the
    Function's backward) against JAX's in interpret mode; padded messages
    carry values that no route may read. Each receiver's first message is
    every channel's largest valid one, so its own shift is JAX's exact
    global maximum and both compute the same bf16 terms."""
    g, msgs, co = _edges(3, c=40)
    msgs = msgs * 2.0 - 1.0
    rp = np.asarray(g.row_ptr)
    firsts = rp[:-1][rp[1:] > rp[:-1]]
    msgs[firsts] = msgs[:rp[-1]].max(0)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    recv, rp = jnp.asarray(g.receivers), jnp.asarray(g.row_ptr)

    def f(m, t):
        out = sp.gen_softmax_aggregate_csr(m, recv, rp, t, grad_weights, True)
        return jnp.sum(out.astype(jnp.float32) * co), out

    (_, want), (gm, gt) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(msgs).astype(jd), jnp.asarray([0.6], jnp.float32))
    m_t = torch.from_numpy(msgs).to(td).requires_grad_(True)
    t_t = torch.tensor([0.6], requires_grad=grad_weights)
    got = tsp.gen_softmax_aggregate_csr(m_t, torch.from_numpy(np.asarray(g.receivers)),
                                        torch.from_numpy(np.asarray(g.row_ptr)), t_t,
                                        grad_weights)
    (got.float() * torch.from_numpy(co)).sum().backward()
    assert got.dtype == td and m_t.grad.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    gm = np.asarray(gm.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, **AGG)
        np.testing.assert_allclose(m_t.grad.numpy(), gm, **AGG_GRAD)
        if grad_weights:
            np.testing.assert_allclose(t_t.grad.numpy(), np.asarray(gt), rtol=1e-4)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=2.0 ** -7,
                                   atol=1e-6)
        rel = (np.linalg.norm(m_t.grad.float().numpy() - gm)
               / max(np.linalg.norm(gm), 1e-30))
        assert rel < 1.5e-2, rel
        if grad_weights:
            np.testing.assert_allclose(t_t.grad.numpy(), np.asarray(gt), rtol=1.5e-2)
    if not grad_weights:
        assert t_t.grad is None


def test_route_misses_are_counted():
    """A graph without ``row_ptr`` or CSC is counted as a route miss (no
    warning on the CPU), as the JAX package's `_miss` counts it."""
    gt, _, _ = _graphs(5, with_csc=False, with_row_ptr=False)
    before = tseg.fastpath_misses()
    tcs.GENConv(16, 16, aggr="softmax")(gt.x, gt)
    after = tseg.fastpath_misses()
    for key in ("fused_gather_agg:graph lacks CSR/CSC aux indices",
                "generalized_aggregate:graph has no CSR row_ptr aux"):
        assert after.get(key, 0) == before.get(key, 0) + 1, key


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

def _zoo_pair(conv, c_in=16, c_out=16, norm="batch", seed=0):
    heads = 4 if conv == "gat" else 1
    jconv = jcs.graph_conv(c_in, c_out, conv, "relu", norm, True, heads)
    params, state = jax.jit(jconv.init)(jax.random.PRNGKey(seed))
    tconv = tcs.GraphConv(c_in, c_out, conv, "relu", norm, True, heads)
    sd = {}
    zoo_conv_entries(sd, "gconv", _np_tree(params), _np_tree(state), conv, norm)
    tconv.load_state_dict(sd, strict=True)
    return jconv, params, state, tconv


def _run_zoo(conv, gt, gj, rng, norm="batch", c=16):
    jconv, params, state, tconv = _zoo_pair(conv, c, c, norm)
    co = rng.standard_normal((gt.num_nodes_padded, c)).astype(np.float32)
    co[gt.n_node:] = 0.0
    x = np.asarray(gj.x)

    def loss_j(p, x_):
        out, ns = jconv.apply(p, state, x_, gj, train=True)
        return jnp.sum(out * co), (out, ns)

    (_, (want, ns)), (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    tconv.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tconv(xt, gt)
    (got * torch.from_numpy(co)).sum().backward()
    n = gt.n_node
    np.testing.assert_allclose(got.detach().numpy()[:n], np.asarray(want)[:n], **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3, atol=1e-5)
    want_g, want_s = {}, {}
    zoo_conv_entries(want_g, "gconv", _np_tree(gp), _np_tree(ns), conv, norm)
    zoo_conv_entries(want_s, "gconv", _np_tree(params), _np_tree(ns), conv, norm)
    _check_grads(dict(tconv.named_parameters()), want_g)
    for k, buf in tconv.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_s[k].numpy(), err_msg=k, **FWD)


@pytest.mark.parametrize("conv", CONVS)
def test_zoo_conv_matches_jax(conv):
    """Forward, new BatchNorm statistics (EdgeConv's over the valid edges,
    padded edges present) and every gradient, gather route."""
    gt, gj, rng = _graphs(10 + CONVS.index(conv))
    assert gt.num_edges_padded > gt.n_edge
    _run_zoo(conv, gt, gj, rng)


@pytest.mark.parametrize("conv", BAND_CONVS)
def test_zoo_conv_band_route_matches_jax(conv, band_mode):
    """On a hub-free band: GCN, GIN and SAGE sum through `band_sum_auto`,
    MRConv's max through `band_extreme`, on both sides."""
    gt, gj, rng = _graphs(20 + BAND_CONVS.index(conv), n=512, band=True)
    assert tband.band_sum_ok(gt) and jband.band_sum_ok(gj)
    _run_zoo(conv, gt, gj, rng)


@pytest.mark.parametrize("kind", ["max", "min"])
def test_band_extreme_matches_jax(kind, band_mode):
    """`band_extreme` forward (window reduce plus leftover) and its
    tie-splitting backward against JAX's, ties present (values on a grid of
    0.5), and against the plain segment reduction."""
    gt, gj, rng = _graphs(30, n=512, c=8, band=True)
    x = np.round(rng.standard_normal((gt.num_nodes_padded, 8)) * 2) / 2
    x = x.astype(np.float32)
    co = rng.standard_normal(x.shape).astype(np.float32)

    def f(x_):
        out = jband.band_extreme(x_, gj.band, gj.senders, gj.receivers, gj.edge_mask, kind)
        return jnp.sum(out * co), out

    (_, want), gx = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tband.band_extreme(xt, gt.band, gt.senders, gt.receivers, gt.edge_mask, kind)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-6, atol=1e-6)
    seg = tseg.scatter(kind, torch.from_numpy(x).index_select(
        0, torch.clamp(gt.senders.long(), max=gt.num_nodes_padded - 1)), gt.receivers,
        gt.num_nodes_padded, gt.edge_mask)
    np.testing.assert_array_equal(got.detach().numpy(), seg.numpy())


@pytest.mark.parametrize("aggr", ["max", "min"])
def test_genconv_band_extreme_matches_jax(aggr, band_mode):
    gt, gj, rng = _graphs(31, n=512, band=True)
    jconv, params, state, holder, cfg = _genconv_pair(aggr, False)
    co = rng.standard_normal((gt.num_nodes_padded, 16)).astype(np.float32)
    x = np.asarray(gj.x)

    def loss_j(p, x_):
        out, _ = jconv.apply(p, state, x_, gj, train=True)
        return jnp.sum(out * co), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    sd = {}
    _genconv(sd, "conv", _np_tree(params), _np_tree(state), cfg, "batch", ())
    holder.load_state_dict(sd, strict=False)
    holder.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = holder.conv(xt, gt)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name,conv", [("mrconv", "mr"), ("edge", "edge"),
                                       ("rsage", "sage"), ("rsage_rel", "rsage"),
                                       ("semigcn", "gcn"), ("gin", "gin")])
def test_zoo_reference_golden(name, conv):
    """The reference's own outputs and gradients (`tests/goldens/ref_*.npz`),
    its `state_dict` loaded by name (`import_deepgcn`) into the bare conv;
    the goldens' tolerances (rtol 5e-4, atol 5e-5)."""
    z = np.load(os.path.join(GOLD, f"ref_{name}.npz"))
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    gd = {k[3:]: z[k] for k in z.files if k.startswith("gd.")}
    ei = z["edge_index"]
    g = build_graph(z["x"], ei[0], ei[1], num_nodes=z["x"].shape[0])
    model = tcs.graph_conv(16, 16, conv)
    import_deepgcn(sd, model)
    x = g.x.clone().requires_grad_(True)
    n = z["co"].shape[0]
    out = model(x, g)[:n]
    (out * torch.from_numpy(z["co"])).sum().backward()
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out.detach().numpy(), z["out"], err_msg="out", **tol)
    np.testing.assert_allclose(x.grad[:n].numpy(), z["gx"], err_msg="gx", **tol)
    named = dict(model.named_parameters())
    assert set(named) == set(gd)
    for k, want in gd.items():
        np.testing.assert_allclose(named[k].grad.numpy(), want, err_msg=k, **tol)


def test_dynamic_convs_wait_for_slice_9():
    """Slice 9 ported them: each builds its own kNN graph over clouds of
    ``num_points`` and keeps the reference's names."""
    x = torch.randn(2 * 12, 16)
    for fn in (tcs.DynConv, tcs.PlainDynBlock, tcs.ResDynBlock, tcs.DenseDynBlock):
        if fn in (tcs.DynConv, tcs.DenseDynBlock):
            m = fn(16, 16, kernel_size=3, num_points=12)
        else:
            m = fn(16, 3, num_points=12)
        out = m(x)
        assert out.shape == ((24, 32) if fn is tcs.DenseDynBlock else (24, 16))
        assert any(k.endswith("gconv.nn.0.weight") for k in m.state_dict())
