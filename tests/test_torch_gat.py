"""The port's GAT attention SpMM (K5/K6 plain versions), `band_gat_agg`, the
row gathers, `_safe_div` and `SymGATConv` on each route, against the JAX
package on the CPU: the Pallas pair in interpret mode as
tests/test_spmm_pallas.py runs it, the band route under
`ops.band._TEST_MODE` as tests/test_band_gat.py runs it. The CUDA kernels
against their plain versions are in test_torch_cuda.py.

Tolerances: the fused pair as tests/test_spmm_pallas.py (value rtol 1e-5,
gradients rtol 5e-4 / atol 1e-5), the band products as tests/test_band.py
(forward rtol 3e-4 / atol 1e-4, gradients rtol 3e-3 / atol 1e-4), the conv
as tests/test_band_gat.py (rtol 2e-3 / atol 2e-4). Both sides run float32;
they differ in the order of their sums and in the route (JAX on the CPU
takes the segment softmax where the port takes K5/K6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.ops.band as jband
from deep_gcns_torch_tpu.convs.dgl_gat import DEN_TINY as JAX_DEN_TINY
from deep_gcns_torch_tpu.convs.dgl_gat import SymGATConv as JaxSymGATConv
from deep_gcns_torch_tpu.convs.dgl_gat import _safe_div as jax_safe_div
from deep_gcns_torch_tpu.graph import attach_band as jax_attach_band
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.ops import gather as jgather
from deep_gcns_torch_tpu.ops import spmm_pallas as jsp
import deep_gcns_torch_tpu_torch.ops.band as tband
from deep_gcns_torch_tpu_torch.convs.dgl_gat import DEN_TINY, SymGATConv, safe_div
from deep_gcns_torch_tpu_torch.graph import attach_band, build_graph
from deep_gcns_torch_tpu_torch.ops import gather as tgather
from deep_gcns_torch_tpu_torch.ops import segment as tseg
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
from torch_budget import budget  # noqa: F401

FUSED_GRAD = dict(rtol=5e-4, atol=1e-5)
BAND_FWD = dict(rtol=3e-4, atol=1e-4)
BAND_GRAD = dict(rtol=3e-3, atol=1e-4)
CONV = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture
def band_mode():
    jband._TEST_MODE = True
    yield
    jband._TEST_MODE = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _fused_graphs(rng, n=300, e=2000):
    """tests/test_spmm_pallas.py's shape: padded to the TPU kernel's tiles."""
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    r[:80] = 5  # one receiver (and in CSC one sender row) longer than a warp's pass
    s[80:160] = 11
    return (build_graph(None, s, r, num_nodes=n, node_pad=384, edge_pad=2560),
            jax_build_graph(None, s, r, num_nodes=n, node_pad=384, edge_pad=2560))


@pytest.mark.parametrize("with_drop", [False, True])
def test_gat_softmax_spmm_matches_pallas_interpret(with_drop):
    """The Function on the plain versions of K5 and K6 against the Pallas
    pair: the packed output and the gradients of the table, through the
    score's el column, with and without the renormalising edge-drop. The
    port's table carries no lane padding (width 126, JAX's 128)."""
    rng = np.random.default_rng(0)
    gt, gj = _fused_graphs(rng)
    n_pad, h, d = 384, 3, 41
    hd = h * d
    feat = rng.standard_normal((n_pad, h, d)).astype(np.float32)
    attn = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    keep = (rng.random(2560) > 0.3).astype(np.float32) if with_drop else None
    co = rng.standard_normal((n_pad, hd + h)).astype(np.float32)

    def f_jax(feat_, attn_):
        el = jnp.einsum("nhd,hd->nh", feat_, attn_)
        t = jnp.pad(jnp.concatenate([feat_.reshape(n_pad, hd), el], 1),
                    ((0, 0), (0, 128 - hd - h)))
        att = jnp.asarray(gj.edge_mask) if keep is None else (
            jnp.asarray(gj.edge_mask) & (jnp.asarray(keep) > 0))
        recv = jnp.where(att, jnp.asarray(gj.receivers), n_pad)
        kc = None if keep is None else jnp.take(jnp.asarray(keep), jnp.asarray(gj.csc_perm))
        agg = jsp.gat_softmax_spmm(t, jnp.asarray(gj.senders), recv, jnp.asarray(gj.row_ptr),
                                   jnp.asarray(gj.csc_senders), jnp.asarray(gj.csc_receivers),
                                   jnp.asarray(gj.csc_col_ptr), kc, hd, h, 0.2, True)
        return jnp.sum(agg[:, :hd + h] * co), agg

    (_, want), (gf_want, ga_want) = jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1),
                                                               has_aux=True))(
        jnp.asarray(feat), jnp.asarray(attn))
    ft, at = _t(feat).requires_grad_(True), _t(attn).requires_grad_(True)
    el = (ft * at).sum(-1)
    t = torch.cat([ft.reshape(n_pad, hd), el], 1)
    att = gt.edge_mask if keep is None else gt.edge_mask & (_t(keep) > 0)
    recv = torch.where(att, gt.receivers, n_pad)
    kc = None if keep is None else _t(keep)[gt.csc_perm.long()]
    got = tsp.gat_softmax_spmm(t, gt.senders, recv, gt.row_ptr, gt.csc_senders,
                               gt.csc_receivers, gt.csc_col_ptr, kc, hd, h, 0.2)
    (got * _t(co)).sum().backward()
    assert got.shape == (n_pad, hd + h)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:, :hd + h],
                               rtol=1e-5, atol=1e-5)
    assert not np.asarray(want)[:, hd + h:].any()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gf_want), **FUSED_GRAD)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga_want), rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("block", [None, 100])
def test_gat_plain_versions_zero_the_padding_columns(monkeypatch, block):
    """A table padded to a multiple of 8 columns keeps zeros there in the
    forward output and in the table's gradient, and the padded output equals
    the unpadded one; the plain versions' edge blocks (here also 100 edges,
    so that the CPU sizes take several) change nothing."""
    rng = np.random.default_rng(1)
    gt, _ = _fused_graphs(rng)
    n_pad, h, d = 384, 2, 5
    t = torch.from_numpy(rng.standard_normal((n_pad, h * d + h)).astype(np.float32))
    args = (gt.senders, gt.receivers, gt.row_ptr, gt.csc_senders, gt.csc_receivers,
            gt.csc_col_ptr, None, h * d, h, 0.2)
    tw = t.clone().requires_grad_(True)
    whole = tsp.gat_softmax_spmm(tw, *args)
    (whole ** 2).sum().backward()
    if block is not None:
        monkeypatch.setattr(tsp, "_PLAIN_EDGE_BLOCK", block)
    tp = torch.nn.functional.pad(t, (0, 4)).requires_grad_(True)
    out = tsp.gat_softmax_spmm(tp, *args)
    np.testing.assert_allclose(out[:, :h * d + h].detach().numpy(), whole.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not out[:, h * d + h:].any()
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tp.grad[:, :h * d + h].numpy(), tw.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert not tp.grad[:, h * d + h:].any()


def test_gat_cmax_matches_jax():
    rng = np.random.default_rng(2)
    t = rng.standard_normal((64, 10)).astype(np.float32)
    t[:, 9] = -np.abs(t[:, 9])  # an all-negative head clamps at the sentinel's 0
    got = tsp.gat_cmax(_t(t), 8, 2)
    want = jsp._gat_cmax(jnp.asarray(t), 8, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == 0.0


def _band_graphs(rng, n=512, hubby=True, deg=6):
    if hubby:
        w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.9
        rng.shuffle(w)
        s = rng.choice(n, n * deg, p=w / w.sum())
    else:
        s = rng.integers(0, n, n * deg)
    r = np.clip(s + rng.integers(-100, 101, n * deg), 0, n - 1)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    hubs = 64 if hubby else None
    gt = attach_band(build_graph(x, s, r, num_nodes=n), window=256, hubs=hubs)
    gj = jax_attach_band(jax_build_graph(x, s, r, num_nodes=n), window=256, hubs=hubs)
    return x, gt, gj


@pytest.mark.parametrize("drop", [False, True])
def test_band_gat_agg_matches_jax(band_mode, drop):
    rng = np.random.default_rng(3)
    _, gt, gj = _band_graphs(rng)
    assert gt.band.fwd.hub_ids is not None and gt.band.fwd.n_lo > 0
    n_pad, h, d = gt.num_nodes_padded, 3, 5
    feat = rng.standard_normal((n_pad, h, d)).astype(np.float32)
    el = rng.standard_normal((n_pad, h)).astype(np.float32)
    co_n = rng.standard_normal((n_pad, h, d)).astype(np.float32)
    co_d = rng.standard_normal((n_pad, h)).astype(np.float32)
    thresh = jband.drop_thresh(0.3)
    jd = jband.DropSpec(k0=jnp.int32(-77), k1=jnp.int32(12345), thresh=thresh) if drop else None
    td = tband.DropSpec(k0=-77, k1=12345, thresh=thresh) if drop else None

    def f(feat_, el_):
        num, den = jband.band_gat_agg(feat_, el_, gj.band, 0.2, interpret="xla", drop=jd)
        return jnp.sum(num * co_n) + jnp.sum(den * co_d), (num, den)

    (_, (num_w, den_w)), (gf_w, ge_w) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
        jnp.asarray(feat), jnp.asarray(el))
    ft, et = _t(feat).requires_grad_(True), _t(el).requires_grad_(True)
    num, den = tband.band_gat_agg(ft, et, gt.band, 0.2, drop=td)
    ((num * _t(co_n)).sum() + (den * _t(co_d)).sum()).backward()
    assert num.dtype == den.dtype == torch.float32
    np.testing.assert_allclose(num.detach().numpy(), np.asarray(num_w), **BAND_FWD)
    np.testing.assert_allclose(den.detach().numpy(), np.asarray(den_w), **BAND_FWD)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gf_w), **BAND_GRAD)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge_w), **BAND_GRAD)


def test_band_gat_dense_route_raises(band_mode):
    """The dense route's gate as JAX's; the route itself (forward against
    JAX's XLA emulation) raises only for the self flavour with edge-drop,
    which neither package composes."""
    rng = np.random.default_rng(4)
    _, gt, gj = _band_graphs(rng, hubby=False)
    assert tband.band_gat_dense_ok(gt) == jband.band_gat_dense_ok(gj) is True
    assert tband.band_gat_dense_ok(gt, 1.01) == jband.band_gat_dense_ok(gj, 1.01) is False
    assert not tband.band_gat_dense_ok(gt.replace(band=None))
    n_pad, h, d = gt.num_nodes_padded, 2, 4
    feat = rng.standard_normal((n_pad, h, d)).astype(np.float32)
    el, er = (rng.standard_normal((n_pad, h)).astype(np.float32) for _ in range(2))
    num, den = tband.band_gat_dense_agg(_t(feat), _t(el), _t(er), gt.band)
    num_w, den_w = jband.band_gat_dense_agg(jnp.asarray(feat), jnp.asarray(el), jnp.asarray(er),
                                            gj.band, interpret="xla")
    np.testing.assert_allclose(num.numpy(), np.asarray(num_w), **BAND_FWD)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_w), **BAND_FWD)
    drop = tband.DropSpec(k0=1, k1=2, thresh=tband.drop_thresh(0.3))
    with pytest.raises(ValueError, match="edge-drop"):
        tband.band_gat_dense_agg(_t(feat), _t(el), _t(er), gt.band, drop=drop,
                                 self_score=_t(el), self_feat=_t(feat),
                                 self_count=torch.zeros(n_pad))


def _gather_graphs(rng, n=200, e=1500):
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    s[:60] = 3  # a hub sender: a CSC range longer than a warp's pass
    return (build_graph(None, s, r, num_nodes=n, edge_pad=2048),
            jax_build_graph(None, s, r, num_nodes=n, edge_pad=2048))


@pytest.mark.parametrize("kind", ["src", "dst"])
def test_gathers_match_jax(kind):
    """gather_src / gather_dst forward and backward (K1's plain version over
    the CSC or CSR ranges) against the JAX package's custom VJPs with the
    Pallas segment sum in interpret mode; the _auto forms and the plain
    fallback of a graph without CSC/CSR give the same values."""
    rng = np.random.default_rng(5)
    gt, gj = _gather_graphs(rng)
    x = rng.standard_normal((gt.num_nodes_padded, 24)).astype(np.float32)
    co = rng.standard_normal((gt.num_edges_padded, 24)).astype(np.float32)
    co[gt.n_edge:] = 0.0  # padding slots gather the clamped last row

    if kind == "src":
        def fj(x_):
            return jgather.gather_src(x_, jnp.asarray(gj.senders), jnp.asarray(gj.csc_perm),
                                      jnp.asarray(gj.csc_senders), jnp.asarray(gj.csc_col_ptr),
                                      True)

        def ft(x_, g):
            return tgather.gather_src_auto(x_, g)
        bare = dict(csc_perm=None, csc_col_ptr=None)
    else:
        def fj(x_):
            return jgather.gather_dst(x_, jnp.asarray(gj.receivers), jnp.asarray(gj.row_ptr),
                                      True)

        def ft(x_, g):
            return tgather.gather_dst_auto(x_, g)
        bare = dict(row_ptr=None)
    want, vjp = jax.vjp(fj, jnp.asarray(x))
    (gwant,) = vjp(jnp.asarray(co))
    for g in (gt, gt.replace(**bare)):
        xt = _t(x).requires_grad_(True)
        got = ft(xt, g)
        (got * _t(co)).sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), rtol=1e-5, atol=1e-5)
    # the dense neighbour gather is ported: a plain copy of the rows
    xs = torch.arange(12.0).reshape(1, 4, 3)
    nbr = torch.tensor([[[1, 2], [0, 0], [3, 1], [2, 2]]])
    np.testing.assert_array_equal(tgather.gather_neighbors(xs, nbr).numpy(),
                                  xs[0][nbr[0]][None].numpy())


@pytest.mark.parametrize("scale", [1.0, 3e-20])
def test_safe_div_matches_jax(scale):
    """Forward and reassociated backward against JAX, on healthy dens and on
    dens just above DEN_TINY, where plain autograd's den² underflows: the
    gradients stay finite and within float32 range."""
    assert DEN_TINY == JAX_DEN_TINY
    rng = np.random.default_rng(6)
    num = rng.standard_normal((32, 2, 8)).astype(np.float32)
    den = (rng.random((32, 2)) + 0.5).astype(np.float32) * np.float32(scale)
    den[0, 0] = DEN_TINY / 2  # below the guard: 0 out, 0 gradients
    num = num * den[..., None]
    co = rng.standard_normal((32, 2, 8)).astype(np.float32)
    want, vjp = jax.vjp(jax_safe_div, jnp.asarray(num), jnp.asarray(den))
    gn_w, gd_w = vjp(jnp.asarray(co))
    nt, dt = _t(num).requires_grad_(True), _t(den).requires_grad_(True)
    out = safe_div(nt, dt)
    (out * _t(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nt.grad.numpy(), np.asarray(gn_w), rtol=1e-5)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(gd_w), rtol=1e-5)
    assert torch.isfinite(nt.grad).all() and torch.isfinite(dt.grad).all()
    assert float(dt.grad.abs().max()) < 3e21
    assert not out[0, 0].any() and not nt.grad[0, 0].any() and dt.grad[0, 0] == 0


def _conv_params(conv_j, key, port: SymGATConv):
    params, _ = jax.jit(conv_j.init)(jax.random.PRNGKey(key))
    sd = {"fc.weight": _t(np.asarray(params["fc"]).T),
          "attn_l": _t(np.asarray(params["attn_l"])[None])}
    if "attn_r" in params:
        sd["attn_r"] = _t(np.asarray(params["attn_r"])[None])
    if "res_fc" in params:
        sd["res_fc.weight"] = _t(np.asarray(params["res_fc"]).T)
    port.load_state_dict(sd)
    return params


@pytest.mark.parametrize("route,kw", [
    ("csc", dict()),
    ("csc", dict(use_symmetric_norm=True, residual=True, drop=True)),
    ("band", dict()),
    ("band", dict(use_symmetric_norm=True, residual=True, drop=True)),
    ("segment", dict(use_symmetric_norm=True, residual=True, drop=True)),
    ("segment", dict(use_attn_dst=True, residual=True)),
    ("band", dict(use_attn_dst=True)),
    ("band", dict(use_attn_dst=True, use_symmetric_norm=True, residual=True, drop=True)),
    ("band", dict(stabilizer="per_receiver", use_symmetric_norm=True, residual=True,
                  drop=True)),
    ("csc", dict(stabilizer="per_receiver", drop=True)),
])
def test_symgat_conv_matches_jax(band_mode, route, kw):
    """SymGATConv's output and every gradient (weights and input) against
    the JAX conv on the same graph: the port's CSC route (K5/K6's plain
    versions) against JAX's CPU route, the segment softmax; the band routes
    against each other (destination scores and the per-receiver stabilizer
    on the dense route, K7–K9's plain versions, against JAX's XLA
    emulation); the segment routes against each other (the port's graph
    without CSC, and the per-receiver stabilizer without a band, which both
    packages run as the segment softmax on the CPU). Edge-drop from an
    explicit hash key."""
    kw = dict(kw)
    drop = kw.pop("drop", False)
    rng = np.random.default_rng(7)
    x, gt, gj = _band_graphs(rng)
    if route != "band":
        gt, gj = gt.replace(band=None), gj.replace(band=None)
    if route == "segment":
        gt = gt.replace(csc_perm=None, csc_senders=None, csc_col_ptr=None, csc_receivers=None)
    h, d = 3, 8
    conf = dict(num_heads=h, edge_drop=0.4 if drop else 0.0, **kw)
    conf.setdefault("use_attn_dst", False)
    conv_j = JaxSymGATConv(32, d, **conf)
    conv_t = SymGATConv(32, d, **conf)
    params = _conv_params(conv_j, 0, conv_t)
    xp = np.zeros((gt.num_nodes_padded, 32), np.float32)
    xp[:x.shape[0]] = x
    co = rng.standard_normal((gt.num_nodes_padded, h, d)).astype(np.float32)
    key = (-123456789, 42)
    jkw = dict(train=True, drop_key=jnp.asarray(key, jnp.int32)) if drop else {}

    def loss(p, x_):
        out, _ = conv_j.apply(p, {}, x_, gj, **jkw)
        return jnp.sum(out * co), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(params,
                                                                         jnp.asarray(xp))
    xt = _t(xp).requires_grad_(True)
    out = conv_t(xt, gt, train=drop, drop_key=key if drop else None)
    (out * _t(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **CONV)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **CONV)
    grads = dict(conv_t.named_parameters())
    np.testing.assert_allclose(grads["fc.weight"].grad.numpy(), np.asarray(gp["fc"]).T, **CONV)
    np.testing.assert_allclose(grads["attn_l"].grad.numpy()[0], np.asarray(gp["attn_l"]),
                               **CONV)
    for name in ("attn_r", "res_fc"):
        if name in gp:
            port = grads[name if name == "attn_r" else "res_fc.weight"].grad.numpy()
            want_g = np.asarray(gp[name])
            np.testing.assert_allclose(port[0] if name == "attn_r" else port,
                                       want_g if name == "attn_r" else want_g.T, **CONV)


def test_symgat_routes_launch_their_kernels_plain_on_cpu(monkeypatch):
    """The conv picks its route by the graph and its scores alone: sender-only
    scores take the band when one is attached, K5/K6 with CSR and CSC, the
    segment softmax otherwise; destination scores and the per-receiver
    stabilizer take the dense route on a band and the segment softmax
    without one (never a global shift)."""
    import deep_gcns_torch_tpu_torch.convs.dgl_gat as tconv

    rng = np.random.default_rng(8)
    x, gt, _ = _band_graphs(rng, n=256)
    calls = []
    for name in ("band_gat_dense_agg", "band_gat_agg", "gat_softmax_spmm", "gather_src_auto"):
        real = getattr(tconv, name)
        monkeypatch.setattr(tconv, name,
                            lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    xt = torch.zeros(gt.num_nodes_padded, 32)
    graphs = (gt, gt.replace(band=None), gt.replace(band=None, csc_col_ptr=None))
    for kw, want in ((dict(use_attn_dst=False),
                      ["band_gat_agg", "gat_softmax_spmm", "gather_src_auto"]),
                     (dict(use_attn_dst=True),
                      ["band_gat_dense_agg", "gather_src_auto", "gather_src_auto"]),
                     (dict(use_attn_dst=False, stabilizer="per_receiver"),
                      ["band_gat_dense_agg", "gather_src_auto", "gather_src_auto"])):
        calls.clear()
        conv = SymGATConv(32, 4, num_heads=2, **kw)
        for g in graphs:
            conv(xt, g)
        assert calls == want, kw
    with pytest.raises(ValueError, match="drop_key"):
        SymGATConv(32, 4, num_heads=2, use_attn_dst=False, edge_drop=0.3)(xt, gt, train=True)
    with pytest.raises(ValueError, match="stabilizer"):
        SymGATConv(32, 4, num_heads=2, stabilizer="global")


@pytest.mark.parametrize("route", ["band", "csc"])
def test_empty_receivers_get_zero(route):
    """Receivers with no incoming edges get exactly 0 (the DEN_TINY guard),
    with finite gradients."""
    rng = np.random.default_rng(9)
    n = 256
    s = rng.integers(0, n, 800)
    r = rng.integers(0, 128, 800)  # the second half receives nothing
    x = rng.standard_normal((n, 32)).astype(np.float32)
    g = attach_band(build_graph(x, s, r, num_nodes=n), window=256)
    if route == "csc":
        g = g.replace(band=None)
    conv = SymGATConv(32, 8, num_heads=2, use_attn_dst=False)
    xt = g.x.clone().requires_grad_(True)
    out = conv(xt, g)
    assert not out[128:].any()
    out.sum().backward()
    assert torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("spread", [90.0, 150.0])
def test_wide_score_spread_envelope(band_mode, spread):
    """tests/test_band_gat.py's envelope: one hub sender scores far above the
    crowd. The global-shift band route zeroes the receivers that do not see
    it (with finite gradients, the DEN_TINY guard), while the dense route
    with er ≡ 0 (the per-receiver stabilizer) stays exact: forward and
    gradients against the port's segment softmax and against JAX's dense
    route."""
    rng = np.random.default_rng(10)
    n, deg = 512, 6
    s = rng.integers(0, n, n * deg)
    r = np.clip(s + rng.integers(-80, 81, n * deg), 0, n - 1)
    s[:8] = 0
    r[:8] = np.arange(8)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    gt = attach_band(build_graph(x, s, r, num_nodes=n), window=256, hubs=None)
    gj = jax_attach_band(jax_build_graph(x, s, r, num_nodes=n), window=256, hubs=None)
    npd, h, d = gt.num_nodes_padded, 2, 16
    feat = rng.standard_normal((npd, h, d)).astype(np.float32)
    el = rng.standard_normal((npd, h)).astype(np.float32)
    el[0] = spread
    co = rng.standard_normal((npd, h, d)).astype(np.float32)

    def dense(el_, f_):
        return safe_div(*tband.band_gat_dense_agg(f_, el_, torch.zeros_like(el_), gt.band))

    def global_route(el_, f_):
        return safe_div(*tband.band_gat_agg(f_, el_, gt.band))

    def segment(el_, f_):
        send = torch.clamp(gt.senders.long(), max=npd - 1)
        score = torch.nn.functional.leaky_relu(el_[send], 0.2)
        alpha = tseg.segment_softmax(score, gt.receivers, npd, mask=gt.edge_mask)
        return tseg.segment_sum(f_[send] * alpha[..., None], gt.receivers, npd,
                                mask=gt.edge_mask)

    def run(fn):
        e_, f_ = _t(el).requires_grad_(True), _t(feat).requires_grad_(True)
        out = fn(e_, f_)
        (out * _t(co)).sum().backward()
        return out.detach(), e_.grad, f_.grad

    out_d, out_g, out_s = run(dense), run(global_route), run(segment)
    for a, b in zip(out_d, out_s):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)
    zeroed = ((out_g[0].abs().sum((1, 2)) == 0) & (out_s[0].abs().sum((1, 2)) > 1e-3))
    assert int(zeroed.sum()) > 0
    assert all(bool(torch.isfinite(t).all()) for t in out_g[1:])

    def jdense(el_, f_):
        num, den = jband.band_gat_dense_agg(f_, el_, jnp.zeros_like(el_), gj.band, 0.2,
                                            interpret="xla")
        return jax_safe_div(num, den)

    want, vjp = jax.vjp(jdense, jnp.asarray(el), jnp.asarray(feat))
    for a, b in zip(out_d, (want,) + vjp(jnp.asarray(co))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-4)


def _pyg_graphs(rng, n=512, hubby=False, self_edges=True):
    """tests/test_band_gat.py's PyG graphs: locality-banded edges, explicit
    self edges for a third of the nodes, on both sides, with their bands."""
    if hubby:
        w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.9
        rng.shuffle(w)
        s = rng.choice(n, n * 6, p=w / w.sum())
    else:
        s = rng.integers(0, n, n * 5)
    r = np.clip(s + rng.integers(-80, 81, s.shape[0]), 0, n - 1)
    if self_edges:
        ids = rng.choice(n, n // 3, replace=False)
        s, r = np.concatenate([s, ids]), np.concatenate([r, ids])
    x = rng.standard_normal((n, 32)).astype(np.float32)
    hubs = 64 if hubby else None
    return (x, attach_band(build_graph(x, s, r, num_nodes=n), window=256, hubs=hubs),
            jax_attach_band(jax_build_graph(x, s, r, num_nodes=n), window=256, hubs=hubs))


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("self_loops,hubby,act,norm", [
    (True, False, "relu", None),
    (True, True, "relu", None),
    (False, True, None, None),
    (True, False, "leakyrelu", "batch"),
    (True, False, "prelu", "batch"),
])
def test_pyg_gatconv_matches_jax(band_mode, band, self_loops, hubby, act, norm):
    """PyG's GATConv (destination and sender halves of one attention vector,
    neighbours and one analytic self term, or the edge list as it is)
    against the JAX conv: the dense route (K7–K9's plain versions, with the
    self_count cancellation of explicit self edges) against JAX's XLA
    emulation, and the per-edge segment route against JAX's; output, input
    gradient and every parameter's gradient, with the weights carried by
    `gat_conv_entries`."""
    from deep_gcns_torch_tpu.convs.sparse import GATConv as JaxGATConv
    from deep_gcns_torch_tpu_torch.convs.sparse import GATConv
    from deep_gcns_torch_tpu_torch.utils.import_jax import gat_conv_entries

    rng = np.random.default_rng(11)
    x, gt, gj = _pyg_graphs(rng, hubby=hubby)
    if not band:
        gt, gj = gt.replace(band=None), gj.replace(band=None)
    h, d = 2, 16
    conv_j = JaxGATConv(32, d, heads=h, act=act, norm=norm, self_loops=self_loops)
    params, state = jax.jit(conv_j.init)(jax.random.PRNGKey(0))
    conv_t = GATConv(32, d, heads=h, act=act, norm=norm, self_loops=self_loops)
    sd = {}
    gat_conv_entries(sd, "", jax.tree_util.tree_map(np.asarray, params))
    sd = {k[1:]: v for k, v in sd.items()}
    if norm is not None:
        sd.update({"unlinear.1.weight": _t(params["norm"]["scale"]),
                   "unlinear.1.bias": _t(params["norm"]["bias"]),
                   "unlinear.1.running_mean": _t(state["norm"]["mean"]),
                   "unlinear.1.running_var": _t(state["norm"]["var"]),
                   "unlinear.1.num_batches_tracked": torch.tensor(0)})
    conv_t.load_state_dict(sd)
    conv_t.train()
    xp = np.zeros((gt.num_nodes_padded, 32), np.float32)
    xp[:x.shape[0]] = x
    co = rng.standard_normal((gt.num_nodes_padded, h * d)).astype(np.float32)

    def loss(p, x_):
        out, _ = conv_j.apply(p, state, x_, gj, train=True)
        return jnp.sum(out * co), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
        params, jnp.asarray(xp))
    xt = _t(xp).requires_grad_(True)
    out = conv_t(xt, gt)
    (out * _t(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **CONV)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **CONV)
    grads = dict(conv_t.named_parameters())
    np.testing.assert_allclose(grads["gconv.weight"].grad.numpy(), np.asarray(gp["w"]), **CONV)
    np.testing.assert_allclose(grads["gconv.att"].grad.numpy()[0], np.asarray(gp["att"]),
                               **CONV)
    np.testing.assert_allclose(grads["gconv.bias"].grad.numpy(), np.asarray(gp["b"]), **CONV)
    if norm is not None:
        np.testing.assert_allclose(grads["unlinear.1.weight"].grad.numpy(),
                                   np.asarray(gp["norm"]["scale"]), **CONV)
    if act == "prelu":
        np.testing.assert_allclose(grads["unlinear.0.weight"].grad.numpy(),
                                   np.asarray(gp["prelu"]), **CONV)


@pytest.mark.parametrize("band", [False, True])
def test_pyg_gatconv_reference_golden(band):
    """tests/goldens/ref_gat.npz (PyG-1.x GATConv of the reference, 4 heads
    of 4, ReLU): its state dict loads as it is, and the output, the input
    gradient and the parameter gradients match on the segment route and on
    the dense route of the same graph's band (tolerances of
    tests/test_reference_goldens.py)."""
    import os

    from deep_gcns_torch_tpu_torch.convs.sparse import GATConv

    z = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ref_gat.npz"))
    ei, x = z["edge_index"], z["x"]
    g = build_graph(x, ei[0], ei[1], num_nodes=x.shape[0])
    if band:
        g = attach_band(g, window=128, hubs=None)
        assert tband.band_gat_dense_ok(g)
    conv = GATConv(16, 4, heads=4, act="relu", norm=None)
    conv.load_state_dict({k[3:]: _t(z[k]) for k in z.files if k.startswith("sd.")})
    xt = g.x.clone().requires_grad_(True)
    out = conv(xt, g)
    (out[:x.shape[0]] * _t(z["co"])).sum().backward()
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out[:x.shape[0]].detach().numpy(), z["out"], **tol)
    np.testing.assert_allclose(xt.grad[:x.shape[0]].numpy(), z["gx"], **tol)
    for name, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), z["gd." + name], err_msg=name, **tol)


def test_pyg_gatconv_refuses_prelu():
    """prelu is ported (one learned slope at `unlinear.0.weight`, 0.2 at
    init, held against JAX in `test_pyg_gatconv_matches_jax`); an
    activation the reference's `act_layer` lacks is still refused."""
    from deep_gcns_torch_tpu_torch.convs.sparse import GATConv

    conv = GATConv(8, 4, heads=2, act="prelu")
    assert conv.state_dict()["unlinear.0.weight"].tolist() == [pytest.approx(0.2)]
    with pytest.raises(NotImplementedError, match="gelu"):
        GATConv(8, 4, heads=2, act="gelu")
