"""Edge features: K2's edge-embedding form and K4 (their plain versions)
through the port's fused Function, GENConv with edge encoders and DeeperGCN's
"per_layer" and "one_time" edge modes, against the JAX package (Pallas
kernels in interpret mode on the CPU) and the reference golden
`ref_genconv_softmax_edge.npz`.

Tolerances follow tests/test_spmm_pallas.py:172-216: forward rtol/atol 2e-5,
dx and dt rtol 5e-4 / atol 1e-5, the encoder weight's gradient atol 1e-4.
In bf16 the per-edge terms round to bf16 in both; what is left is the order
of the float32 sums, so the outputs agree to one bf16 ulp (2^-7 relative)
above a floor of 1e-3 of the largest value, where sums cancel."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.convs.sparse import GENConv as JaxGENConv
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu.ops import spmm_pallas as sp
from deep_gcns_torch_tpu_torch.convs.sparse import GENConv
from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
from deep_gcns_torch_tpu_torch.utils.import_jax import deeper_gcn_state_dict_from_jax
from np_ref import with_top_sender
from torch_budget import budget  # noqa: F401

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=1e-5)


def _graphs(seed, n=300, e=2000, c=128, edge_dim=8, top=False):
    """The same random graph for JAX and the port; ``top`` adds a top sender
    (`np_ref.with_top_sender`)."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, c)).astype(np.float32)
    if top:
        x, s, r = with_top_sender(x, s, r)
    ea = rng.standard_normal((s.shape[0], edge_dim)).astype(np.float32)
    kw = dict(edge_attr=ea, num_nodes=n, node_pad=384, edge_pad=2560)
    return jax_build_graph(x, s, r, **kw), build_graph(x, s, r, **kw)


def _jax_args(g):
    return tuple(jnp.asarray(a) for a in (g.senders, g.receivers, g.row_ptr, g.csc_senders,
                                          g.csc_receivers, g.csc_col_ptr))


def _port_args(g):
    return (g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr, g.csc_order)


@pytest.mark.parametrize("grad_weights", [False, True])
def test_fused_with_edge_emb_matches_pallas(grad_weights):
    """out, dx, d(encoder W) and dt in float32: K2 with `ee` forward and K4
    backward (plain versions) against the Pallas pair in interpret mode."""
    gj, gt = _graphs(0)
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((8, 128)) * 0.3).astype(np.float32)
    x = np.asarray(gj.x, np.float32)
    co = rng.standard_normal((gj.num_nodes_padded, 128)).astype(np.float32)
    args = _jax_args(gj)
    ea, ea_csc = jnp.asarray(gj.edge_attr), jnp.asarray(gj.edge_attr_csc)

    def f(x_, w_, t_):
        out = sp.fused_softmax_gather_agg(x_, *args, t_, jax.lax.stop_gradient(ea @ w_),
                                          ea_csc @ w_, 1e-7, grad_weights, True)
        return jnp.sum(out * co), out

    (_, want), (gx, gw, gt_) = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(w), jnp.float32(0.8))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tt = torch.tensor([0.8], requires_grad=grad_weights)
    out = tsp.fused_softmax_gather_agg(xt, *_port_args(gt), tt, ee=(gt.edge_attr @ wt).detach(),
                                       ee_csc=gt.edge_attr_csc @ wt, eps=1e-7,
                                       grad_weights=grad_weights)
    (out * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=5e-4, atol=1e-4)
    if grad_weights:
        np.testing.assert_allclose(float(tt.grad), float(gt_), **GRAD)
    else:
        assert tt.grad is None and float(gt_) == 0.0


def _bf16_backward(gj, x, ee, co, t, grad_weights):
    """(dx, d(ee_csc)) of the port's bf16 contract written out in float32 on
    the bf16 values, edge by edge in receiver order: m = relu(x[s] + ee) + ε,
    the row's shift M = max t·m, den = Σ bf16(exp(t·m − M)), lse = M +
    log(den), out = Σ bf16(w·m)/den; a = exp(t·m − lse[r]), dm = g[r]·a
    (·(1 + t·(m − out[r])) with learned weights), d(ee) = bf16(dm where
    x[s] + ee > 0) and dx the float32 sum of those, rounded to bf16. Also
    each term's slack against the Pallas pair, summed per sender for dx: one
    bf16 ulp of the term (its two roundings), 2^-8 of it (the Pallas pair's
    bf16 g/den), and with learned weights one ulp of out[r] (the two
    forwards' outs, one ulp apart) times |g·a·t|."""
    def bf(a):
        return torch.as_tensor(np.asarray(a, np.float32)).bfloat16().float()
    ne, n_pad = gj.n_edge, gj.num_nodes_padded
    s = torch.from_numpy(np.asarray(gj.senders[:ne], np.int64))
    r = torch.from_numpy(np.asarray(gj.receivers[:ne], np.int64))
    xj = bf(x)[s] + bf(ee)[:ne]
    m = torch.relu(xj) + 1e-7
    sc = m * t
    c = sc.shape[1]
    top = torch.full((n_pad, c), float("-inf")).scatter_reduce(0, r[:, None].expand(-1, c),
                                                                sc, "amax")
    w = torch.exp(sc - top[r])
    den = torch.zeros(n_pad, c).index_add(0, r, w.bfloat16().float())
    num = torch.zeros(n_pad, c).index_add(0, r, (w * m).bfloat16().float())
    safe = torch.where(den > 0, den, 1.0)
    out = (num / safe).bfloat16().float()
    lse = top + torch.log(safe)
    qa = bf(co)[r] * torch.exp(sc - lse[r])
    dm, out_slack = qa, 0.0
    if grad_weights:
        dm = qa * (1.0 + t * (m - out[r]))
        out_slack = 2 ** -7 * (qa * t * out[r]).abs()
    dxj = torch.where(xj > 0, dm, 0.0).bfloat16().float()
    slack = torch.where(xj > 0, (2 ** -7 + 2 ** -8) * dxj.abs() + out_slack, 0.0)
    dx = torch.zeros(n_pad, c).index_add(0, s, dxj).bfloat16().float()
    dx_slack = torch.zeros(n_pad, c).index_add(0, s, slack)
    dee, dee_slack = torch.zeros(gj.num_edges_padded, c), torch.zeros(gj.num_edges_padded, c)
    perm = torch.from_numpy(np.asarray(gj.csc_perm[:ne], np.int64))
    dee[:ne], dee_slack[:ne] = dxj[perm], slack[perm]
    return dx.numpy(), dee.numpy(), dx_slack.numpy(), dee_slack.numpy()


@pytest.mark.parametrize("grad_weights", [False, True])
def test_bf16_edge_terms_round_like_pallas(grad_weights):
    """bf16 x and embeddings: out, dx and d(ee_csc) against the Pallas pair,
    which rounds each edge's terms to bf16 before its float32 sums, and dx
    and d(ee_csc) also against the same rounding of the port's backward
    written out here. The top senders' edges carry each channel's largest
    embedding (over all E_pad rows, as the Pallas bound takes it), so each
    receiver's own shift is the Pallas pair's global bound and the forward
    terms are the same numbers. The backward's terms differ by one rounding:
    the Pallas pair rounds g/den to bf16 (2^-8 relative at most) where the
    port reads each edge's normalised weight from the float32
    log-normaliser. So the gradients meet their own contract within one
    bf16 ulp, and the Pallas pair's within one ulp of the result and each
    term's slack (`_bf16_backward`), summed over a sender's terms for dx,
    where terms of both signs cancel."""
    gj, gt = _graphs(2, n=250, e=1500, top=True)
    rng = np.random.default_rng(3)
    x = np.asarray(gj.x, np.float32)
    ee = (rng.standard_normal((gj.num_edges_padded, 128)) * 0.5).astype(np.float32)
    ee[np.asarray(gj.senders) < 25] = ee.max(0)  # nodes 0-24, the top senders
    ee_csc = ee[np.asarray(gj.csc_perm)]
    co = rng.standard_normal((gj.num_nodes_padded, 128)).astype(np.float32)
    bf = jnp.bfloat16

    def f(x_, e_csc):
        out = sp.fused_softmax_gather_agg(x_, *_jax_args(gj), jnp.float32(0.9),
                                          jnp.asarray(ee, bf), e_csc, 1e-7, grad_weights,
                                          True)
        return jnp.sum(out.astype(jnp.float32) * co), out

    (_, want), (jx, jee) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x, bf), jnp.asarray(ee_csc, bf))
    gx, gee, gx_slack, gee_slack = _bf16_backward(gj, x, ee, co, np.float32(0.9), grad_weights)

    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    et = torch.from_numpy(ee_csc).bfloat16().requires_grad_(True)
    out = tsp.fused_softmax_gather_agg(xt, *_port_args(gt), torch.tensor([0.9]),
                                       ee=torch.from_numpy(ee).bfloat16(), ee_csc=et,
                                       eps=1e-7, grad_weights=grad_weights)
    (out.float() * torch.from_numpy(co)).sum().backward()
    for got, ref in ((out, want), (xt.grad, gx), (et.grad, gee)):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().detach().numpy(), ref, rtol=2 ** -7,
                                   atol=1e-3 * np.abs(ref).max())
    for got, ref, slack in ((xt.grad, jx, gx_slack), (et.grad, jee, gee_slack)):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        bound = 2 ** -7 * np.abs(ref) + slack + 1e-3 * np.abs(ref).max()
        assert (np.abs(got - ref) <= bound).all(), np.max(np.abs(got - ref) - bound)
    n_valid = gt.n_edge
    assert not et.grad[n_valid:].any()  # padded edge rows get no cotangent


def _conv_state(params, learn_t: bool) -> dict:
    """GENConv (mlp_layers=1) JAX params → the port's state_dict (a fixed t
    is a buffer, not an entry)."""
    p = jax.tree_util.tree_map(np.asarray, params)
    sd = {"mlp.0.weight": p["mlp"][0]["lin"]["w"].T, "mlp.0.bias": p["mlp"][0]["lin"]["b"],
          "edge_encoder.weight": p["edge_encoder"]["w"].T,
          "edge_encoder.bias": p["edge_encoder"]["b"]}
    if learn_t:
        sd["t"] = p["t"]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.mark.parametrize("aggr,learn_t,csc", [("softmax", True, True),
                                              ("softmax_sg", False, True),
                                              ("softmax", True, False),
                                              ("mean", False, True)])
def test_genconv_with_edges_matches_jax(aggr, learn_t, csc):
    """The conv encodes the edge features itself. With the sender-ordered
    copy the softmax family takes the fused route (K2 with `ee`, K4); without
    it, and for the other aggregators, the gather route."""
    gj, gt = _graphs(4, n=200, e=1200, c=16, edge_dim=6)
    if not csc:
        gt = gt.replace(edge_attr_csc=None)
        gj = gj.replace(edge_attr_csc=None)
    jconv = JaxGENConv(16, 16, aggr=aggr, t=0.6, learn_t=learn_t, encode_edge=True,
                       edge_feat_dim=6, norm="layer", mlp_layers=1)
    params, state = jax.jit(jconv.init)(jax.random.PRNGKey(0))
    x = np.asarray(gj.x, np.float32)
    co = np.random.default_rng(5).standard_normal((gj.num_nodes_padded, 16)).astype(
        np.float32)

    def f(p, x_):
        out, _ = jconv.apply(p, state, x_, gj, train=True)
        return jnp.sum(out * co), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    conv = GENConv(16, 16, aggr=aggr, t=0.6, learn_t=learn_t, encode_edge=True,
                   edge_feat_dim=6, norm="layer", mlp_layers=1)
    conv.load_state_dict(_conv_state(params, learn_t))
    conv.train()
    calls = []
    real = tsp.softmax_bwd_csc_plain
    tsp.softmax_bwd_csc_plain = lambda *a: calls.append(1) or real(*a)
    try:
        xt = torch.from_numpy(x).requires_grad_(True)
        out = conv(xt, gt)
        (out * torch.from_numpy(co)).sum().backward()
    finally:
        tsp.softmax_bwd_csc_plain = real
    assert len(calls) == int(csc and aggr != "mean")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3, atol=1e-5)
    want_g = _conv_state(gp, learn_t)
    for k, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, rtol=1e-3,
                                   atol=1e-5)


def test_genconv_edge_reference_golden():
    """GENConv (softmax, learn_t, msg_norm, edge encoder, two-layer batch-norm
    MLP) against the reference's own outputs and gradients."""
    z = np.load(os.path.join(GOLD, "ref_genconv_softmax_edge.npz"))
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    gd = {k[3:]: z[k] for k in z.files if k.startswith("gd.")}
    ei = z["edge_index"]
    g = build_graph(z["x"], ei[0], ei[1], num_nodes=z["x"].shape[0],
                    edge_attr=z["edge_attr"])
    conv = GENConv(16, 16, aggr="softmax", learn_t=True, msg_norm=True,
                   learn_msg_scale=True, encode_edge=True, edge_feat_dim=8, norm="batch",
                   mlp_layers=2)
    conv.load_state_dict(sd)
    conv.train()
    x = g.x.clone().requires_grad_(True)
    n = z["co"].shape[0]
    out = conv(x, g)
    (out[:n] * torch.from_numpy(z["co"])).sum().backward()
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out[:n].detach().numpy(), z["out"], err_msg="out", **tol)
    np.testing.assert_allclose(x.grad[:n].numpy(), z["gx"], err_msg="gx", **tol)
    named = dict(conv.named_parameters())
    assert set(named) == set(gd)
    for k, want in gd.items():
        np.testing.assert_allclose(named[k].grad.numpy(), want, err_msg=k, **tol)


@pytest.mark.parametrize("edge_mode,block", [("per_layer", "res+"), ("one_time", "res+"),
                                             ("per_layer", "res")])
def test_deeper_gcn_edge_modes_match_jax(edge_mode, block):
    """The proteins DeeperGCN (one-hot species encoder, edge encoders, layer
    norm, learned t, no final dropout) at dropout 0: logits and every
    parameter gradient against the JAX model on carried-across weights."""
    kw = dict(in_channels=8, hidden_channels=16, num_tasks=5, num_layers=4, block=block,
              aggr="softmax", t=1.0, learn_t=True, norm="layer", mlp_layers=1,
              dropout=0.0, edge_mode=edge_mode, edge_feat_dim=8, use_one_hot_encoding=True,
              node_feat_dim=8, final_dropout=False)
    rng = np.random.default_rng(6)
    n, e = 150, 900
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    ea = rng.random((e, 8)).astype(np.float32)
    gj = jax_build_graph(None, s, r, edge_attr=ea, num_nodes=n)
    gt = build_graph(None, s, r, edge_attr=ea, num_nodes=n)
    species = np.eye(8, dtype=np.float32)[rng.integers(0, 8, gt.num_nodes_padded)]
    nf = rng.standard_normal((gt.num_nodes_padded, 8)).astype(np.float32)
    co = rng.standard_normal((gt.num_nodes_padded, 5)).astype(np.float32)
    co[n:] = 0.0
    jcfg = JaxConfig(**kw)
    jmodel = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))

    def loss_j(p):
        out, _ = jmodel.apply(p, state, jnp.asarray(species), gj, train=True,
                              node_feats=jnp.asarray(nf))
        return jnp.sum(out * co), out

    (_, want), gp = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = DeeperGCN(DeeperGCNConfig(**kw))
    model.load_state_dict(deeper_gcn_state_dict_from_jax(tree, {}, jcfg))
    model.train()
    out = model(torch.from_numpy(species), gt, node_feats=torch.from_numpy(nf))
    (out * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want_g = deeper_gcn_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp), {}, jcfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    g_max = max(float(np.abs(v.numpy()).max()) for v in want_g.values())
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, rtol=1e-3,
                                   atol=1e-5 * g_max)


@pytest.mark.parametrize("c, vec, want", [(40, 4, (10, 3)), (64, 4, (16, 2)), (128, 4, (32, 1)),
                                          (256, 4, (32, 1)), (41, 1, (32, 1)), (3, 1, (3, 10)),
                                          (30, 1, (30, 1))])
def test_k2_lane_groups(c, vec, want):
    """K2's lane layout: G groups of w lanes, w·vec channels a group, w·G ≤ 32;
    a row wider than 32·vec takes one group and walks its channels in chunks."""
    w, groups = tsp.k2_lane_groups(c, vec)
    assert (w, groups) == want
    assert w * groups <= 32 and (w * vec >= c or w == 32)


@pytest.mark.parametrize("c, vec", [(40, 4), (64, 4), (128, 4), (41, 1)])
def test_k2_float32_takes_one_group(c, vec):
    """float32 K2 keeps one group of 32 lanes at every width, so that its
    sums run in edge order (test_float32_hub_row_sums_keep_edge_order)."""
    assert tsp.k2_lane_groups(c, vec, torch.float32) == (32, 1)
    assert tsp.k2_lane_groups(c, vec, torch.bfloat16) == tsp.k2_lane_groups(c, vec)


@pytest.mark.parametrize("c, vec, want", [(40, 4, (10, 3)), (64, 4, (16, 2)), (128, 4, (32, 1)),
                                          (256, 4, (32, 1)), (41, 1, (32, 1)), (3, 1, (3, 10)),
                                          (30, 1, (30, 1))])
def test_k4_lane_groups(c, vec, want):
    """K4's lane layout in bf16: G groups of w lanes over a sender row's
    edges, w·vec channels a group, w·G ≤ 32; a row wider than 32·vec takes
    one group and walks its channels in chunks. bf16 C=40 is 3 groups."""
    w, groups = tsp.k4_lane_groups(c, vec)
    assert (w, groups) == want
    assert w * groups <= 32 and (w * vec >= c or w == 32)


@pytest.mark.parametrize("c, vec", [(40, 4), (64, 4), (128, 4), (41, 1)])
def test_k4_float32_takes_one_group(c, vec):
    """float32 K4 keeps one group of 32 lanes at every width, so that a hub
    sender's dx sums its edges in order, as K2's float32 rows do."""
    assert tsp.k4_lane_groups(c, vec, torch.float32) == (32, 1)


@pytest.mark.parametrize("h, d, vec, want", [(3, 128, 4, (3, 32, 1)), (3, 256, 4, (3, 32, 1)),
                                             (1, 40, 4, (1, 10, 3)), (1, 64, 4, (1, 16, 2)),
                                             (2, 41, 1, (8, 32, 1)), (1, 12, 1, (1, 12, 2))])
def test_k5_layout(h, d, vec, want):
    """K5's walk across a receiver row's H·D columns in bf16: K2's lane
    groups for a narrow row (1 x 40: 3 groups of 10 lanes, nch 1); else one
    group of 32 lanes and the fewest of its forms that cover H·D, or the
    widest, which walks a wider row (3 x 256) in column chunks."""
    nch, w, groups = tsp.k5_layout(h, d, vec)
    assert (nch, w, groups) == want
    assert w * groups <= 32
    if groups > 1:
        assert nch == 1 and w * vec >= h * d
    else:
        assert nch in tsp._K5_FORMS[vec]
        assert nch * 32 * vec >= h * d or nch == max(tsp._K5_FORMS[vec])


@pytest.mark.parametrize("h, d, vec", [(1, 40, 4), (3, 128, 4), (1, 12, 1)])
def test_k5_float32_takes_one_group(h, d, vec):
    """float32 K5 keeps one group at every width, so that each column sums
    its edges in edge order, as the first form did."""
    nch, w, groups = tsp.k5_layout(h, d, vec, torch.float32)
    assert (w, groups) == (32, 1) and nch * 32 * vec >= min(h * d, 384)


def _hub_graphs(seed, n=300, e=2000, hub=600, c=128):
    """_graphs' shape with a hub row (row 7, ``hub`` in-edges) and 20 rows
    that receive no edge."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n - 20, e)
    r[:hub] = 7
    x = rng.standard_normal((n, c)).astype(np.float32)
    ea = rng.standard_normal((e, 8)).astype(np.float32)
    kw = dict(edge_attr=ea, num_nodes=n, node_pad=384, edge_pad=2560)
    return jax_build_graph(x, s, r, **kw), build_graph(x, s, r, **kw)


@pytest.mark.parametrize("with_ee", [False, True])
@pytest.mark.parametrize("c", [128, 40])
def test_softmax_agg_hub_and_empty_rows_match_pallas(with_ee, c):
    """K2's plain version (with and without edge embeddings) against the
    Pallas kernel in interpret mode on a graph with a hub row of 600 edges
    and rows with no edge, which come out exact 0; C=40 against JAX's
    lane-padding wrapper."""
    gj, gt = _hub_graphs(5, c=c)
    rng = np.random.default_rng(6)
    x = np.asarray(gj.x, np.float32)
    ee = ee_csc = None
    if with_ee:
        w = (rng.standard_normal((8, c)) * 0.3).astype(np.float32)
        ee, ee_csc = np.asarray(gj.edge_attr) @ w, np.asarray(gj.edge_attr_csc) @ w
    want = sp.fused_softmax_gather_agg_auto(
        jnp.asarray(x), *_jax_args(gj), jnp.float32(0.8),
        None if ee is None else jnp.asarray(ee), None if ee is None else jnp.asarray(ee_csc),
        1e-7, False, True)
    tt = torch.tensor([0.8])
    xt = torch.from_numpy(x)
    et = None if ee is None else torch.from_numpy(ee)
    out, lse = tsp.softmax_agg(xt, gt.senders, gt.row_ptr, gt.row_order, tt, 1e-7, et)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)
    empty = (gt.row_ptr[1:] == gt.row_ptr[:-1]).nonzero()[:, 0]
    assert empty.numel() >= 20
    assert not out[empty].any() and not lse[empty].any()
    assert int(gt.row_ptr[8] - gt.row_ptr[7]) >= 600


def test_float32_hub_row_sums_keep_edge_order():
    """Why K2's float32 form adds its terms in edge order: on a hub row whose
    messages mostly sit at relu's floor, the terms are near-equal and a
    sequential float32 sum carries an order-dependent bias, so the same
    terms summed by interleaved lane groups (3 groups, partial sums added
    in group order) move the result by more than float32's 1e-5 agreement.
    The plain version's den (read back from its log-normaliser, lse = M +
    log(den) with M the row's maximum score) is the sequential sum in edge
    order, bit for bit."""
    rng = np.random.default_rng(0)
    e, c, hub = 8000, 40, 3
    s = rng.integers(0, 64, e)
    r = np.full(e, hub)
    g = build_graph(None, s, r, num_nodes=64)
    x = torch.from_numpy(rng.standard_normal((g.num_nodes_padded, c)).astype(np.float32))
    ee = torch.from_numpy((rng.standard_normal((g.num_edges_padded, c)) * 0.8)
                          .astype(np.float32))
    t = torch.tensor([0.9])
    _, lse = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    lo, hi = int(g.row_ptr[hub]), int(g.row_ptr[hub + 1])
    m = torch.relu(x[g.senders[lo:hi].long()] + ee[lo:hi]) + 1e-7
    top = (m * t).amax(0)
    w = torch.exp(m * t - top).numpy()
    seq = np.zeros(c, np.float32)
    for row in w:
        seq = seq + row
    want = top + torch.log(torch.from_numpy(seq))
    np.testing.assert_array_equal(lse[hub].numpy(), want.numpy())
    parts = []
    for grp in range(3):
        p = np.zeros(c, np.float32)
        for row in w[grp::3]:
            p = p + row
        parts.append(p)
    grouped = (parts[0] + parts[1]) + parts[2]
    assert np.max(np.abs(grouped - seq) / seq) > 1e-5, np.max(np.abs(grouped - seq) / seq)
