"""The port's dense destination-score GAT (`ops/gat_dense.py`): the plain
versions of K7–K9 and the `gat_dense_agg` Function against the JAX package
on the CPU, the Pallas kernels in interpret mode as
tests/test_gat_dense_kernels.py runs them. The CUDA kernels against their
plain versions are in test_torch_cuda.py.

Sizes and graphs are tests/test_gat_dense_kernels.py's: n=512, 3 heads of
16, window 256, hubs of degree ≥ 64 (hub columns, hub rows and a leftover),
or a hub-free band. Tolerances: JAX's own rtol 2e-4 / atol 2e-5 in float32;
in bf16 the leftover's K1 sums and the forward's products round to bf16, so
one ulp (2^-8 relative) of a partial sum passes into the result: rtol 1e-2 /
atol 1e-3. The stabilizer M is compared exactly: a maximum rounds nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.ops.band as jband
from deep_gcns_torch_tpu.graph import attach_band as jax_attach_band
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.ops import gat_dense as jgd
import deep_gcns_torch_tpu_torch.ops.band as tband
from deep_gcns_torch_tpu_torch.graph import attach_band, build_graph
from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def make_inputs(rng, n=512, deg=6, h=3, d=16, hubby=True, self_edges=False):
    """tests/test_gat_dense_kernels.py's graphs (optionally with explicit self
    edges for a third of the nodes), both packages' bands and float32 node
    tables from the seed."""
    if hubby:
        w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.9
        rng.shuffle(w)
        s = rng.choice(n, n * deg, p=w / w.sum())
    else:
        s = rng.integers(0, n, n * deg)
    r = np.clip(s + rng.integers(-100, 101, n * deg), 0, n - 1)
    if self_edges:
        ids = rng.choice(n, n // 3, replace=False)
        s, r = np.concatenate([s, ids]), np.concatenate([r, ids])
    x = rng.standard_normal((n, 8)).astype(np.float32)
    hubs = 64 if hubby else None
    gj = jax_attach_band(jax_build_graph(x, s, r, num_nodes=n), window=256, hubs=hubs)
    gt = attach_band(build_graph(x, s, r, num_nodes=n), window=256, hubs=hubs)
    np_ = gt.num_nodes_padded
    tabs = {k: rng.standard_normal(shape).astype(np.float32) for k, shape in (
        ("feat", (np_, h, d)), ("el", (np_, h)), ("er", (np_, h)), ("co_n", (np_, h, d)),
        ("co_d", (np_, h)))}
    return gj, gt, tabs


def _drops(dropping):
    if not dropping:
        return None, None
    thresh = jband.drop_thresh(0.4)
    return (jband.DropSpec(k0=jnp.int32(-77), k1=jnp.int32(12345), thresh=thresh),
            tband.DropSpec(k0=-77, k1=12345, thresh=thresh))


CASES = [(False, False), (True, False), (True, True), (False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hubby,dropping", CASES)
def test_plain_kernels_match_pallas_interpret(hubby, dropping, dtype):
    """win_fused_plain, win_der_plain and win_dsend_plain against
    `_win_fused_call`, `_win_der_call` and `_win_dsend_call` with
    interpret=True, on the same inputs: the window band and, on the hubby
    graph, its in-kernel hub columns; m_other lifts every seventh receiver's
    stabilizer. M exactly, the rest at the stated tolerance."""
    rng = np.random.default_rng(0)
    gj, gt, tb = make_inputs(rng, hubby=hubby)
    np_, h, d = tb["feat"].shape
    if hubby:
        assert tgd._hub_in_kernel(gt.band.fwd) and tgd._hub_in_kernel(gt.band.bwd)
    jd, td = _drops(dropping)
    cd = JDT[dtype]
    mo = np.full((np_, h), tgd.NEG, np.float32)
    mo[::7] = 1.5
    gn = rng.standard_normal((np_, h, d)).astype(np.float32)
    gd = rng.standard_normal((np_, h)).astype(np.float32)
    el, er = tb["el"], tb["er"]
    fc = jnp.asarray(tb["feat"].reshape(np_, h * d)).astype(cd)
    ft = _t(tb["feat"]).reshape(np_, h * d).to(dtype)
    gnt = _t(gn).reshape(np_, h * d).to(dtype)
    tol = TOL[dtype]

    num, den, m = jgd._win_fused_call(gj.band.fwd, jnp.asarray(el), jnp.asarray(er),
                                      jnp.asarray(mo), fc, 0.2, jd, cd, True)
    tnum, tden, tm = tgd.win_fused_plain(gt.band.fwd, _t(el), _t(er), _t(mo), ft, 0.2, td)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(m))
    np.testing.assert_allclose(tnum.numpy(), np.asarray(num).reshape(np_, h * d), **tol)
    np.testing.assert_allclose(tden.numpy(), np.asarray(den), **tol)

    der = jgd._win_der_call(gj.band.fwd, jnp.asarray(el), jnp.asarray(er), m, fc,
                            jnp.asarray(gn), jnp.asarray(gd), 0.2, jd, cd, True)
    tder = tgd.win_der_plain(gt.band.fwd, _t(el), _t(er), tm, ft, gnt, _t(gd), 0.2, td)
    np.testing.assert_allclose(tder.numpy(), np.asarray(der), **tol)

    d_el, d_f = jgd._win_dsend_call(gj.band.bwd, jnp.asarray(el), jnp.asarray(er), m, fc,
                                    jnp.asarray(gn), jnp.asarray(gd), 0.2, jd, cd, True)
    tdel, tdf = tgd.win_dsend_plain(gt.band.bwd, _t(el), _t(er), tm, ft, gnt, _t(gd), 0.2, td)
    np.testing.assert_allclose(tdel.numpy(), np.asarray(d_el), **tol)
    np.testing.assert_allclose(tdf.numpy(), np.asarray(d_f).reshape(np_, h * d), **tol)


def _jax_agg(gj, tb, jd, interp, cdt=None, self_flavour=False):
    """(num, den) and the gradients of Σ num·co_n + Σ den·co_d by feat, el,
    er (and self_score) through JAX's `gat_dense_agg`."""
    n = tb["feat"].shape[0]
    c_self = None
    if self_flavour:
        c_self = jax.ops.segment_sum(
            (gj.edge_mask & (gj.senders == gj.receivers)).astype(jnp.float32),
            jnp.minimum(gj.receivers, n - 1), n, indices_are_sorted=True)

    def loss(f, l, r_):
        ss = jax.nn.leaky_relu(l + r_, 0.2) if self_flavour else None
        num, den = jgd.gat_dense_agg(f, l, r_, ss, f if self_flavour else None, c_self,
                                     gj.band, jd, 0.2, cdt, interp)
        return jnp.sum(num * tb["co_n"]) + jnp.sum(den * tb["co_d"]), (num, den)

    (_, out), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        jnp.asarray(tb["feat"]), jnp.asarray(tb["el"]), jnp.asarray(tb["er"]))
    return out, grads, c_self


def _torch_agg(fn, gt, tb, td, cdt=None, c_self=None):
    f, l, r = (_t(tb[k]).requires_grad_(True) for k in ("feat", "el", "er"))
    ss = torch.nn.functional.leaky_relu(l + r, 0.2) if c_self is not None else None
    num, den = fn(f, l, r, ss, f if c_self is not None else None,
                  None if c_self is None else _t(c_self), gt.band, td, 0.2, cdt)
    ((num * _t(tb["co_n"])).sum() + (den * _t(tb["co_d"])).sum()).backward()
    return (num, den), (f.grad, l.grad, r.grad)


def _assert_agg(got, want, tol):
    (num, den), grads = got
    (num_w, den_w), grads_w = want
    assert num.dtype == den.dtype == torch.float32
    np.testing.assert_allclose(num.detach().numpy(), np.asarray(num_w), **tol)
    np.testing.assert_allclose(den.detach().numpy(), np.asarray(den_w), **tol)
    for a, b in zip(grads, grads_w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("interp", ["xla", True])
@pytest.mark.parametrize("hubby,dropping", CASES)
def test_gat_dense_agg_matches_jax(hubby, dropping, interp):
    """The Function, forward and every gradient, against JAX's
    `gat_dense_agg` through its XLA emulation and through the Pallas
    kernels in interpret mode, float32."""
    rng = np.random.default_rng(1)
    gj, gt, tb = make_inputs(rng, hubby=hubby)
    jd, td = _drops(dropping)
    out, grads, _ = _jax_agg(gj, tb, jd, interp)
    _assert_agg(_torch_agg(tgd.gat_dense_agg, gt, tb, td), (out, grads), TOL[torch.float32])


@pytest.mark.parametrize("dropping", [False, True])
def test_gat_dense_agg_bf16_matches_jax(dropping):
    """The compute dtype bf16 (feature tables, the rounded weights, the
    leftover's packed K1 sums) against JAX with cdt=bfloat16."""
    rng = np.random.default_rng(2)
    gj, gt, tb = make_inputs(rng, hubby=True)
    jd, td = _drops(dropping)
    out, grads, _ = _jax_agg(gj, tb, jd, True, jnp.bfloat16)
    _assert_agg(_torch_agg(tgd.gat_dense_agg, gt, tb, td, torch.bfloat16), (out, grads),
                TOL[torch.bfloat16])


@pytest.mark.parametrize("hubby", [False, True])
def test_gat_dense_agg_self_flavour_matches_jax(hubby):
    """PyG's analytic self term with explicit self edges cancelled by the
    (1 − self_count) weight: forward and the gradients by feat (also through
    self_feat), el and er (also through self_score)."""
    rng = np.random.default_rng(3)
    gj, gt, tb = make_inputs(rng, hubby=hubby, self_edges=True)
    out, grads, c_self = _jax_agg(gj, tb, None, True, self_flavour=True)
    _assert_agg(_torch_agg(tgd.gat_dense_agg, gt, tb, None, c_self=np.asarray(c_self)),
                (out, grads), TOL[torch.float32])
    with pytest.raises(ValueError, match="edge-drop"):
        _torch_agg(tgd.gat_dense_agg, gt, tb, _drops(True)[1], c_self=np.asarray(c_self))


@pytest.mark.parametrize("dropping", [False, True])
def test_hub_columns_past_the_kernel_cap(monkeypatch, dropping):
    """A band with more hub columns than a kernel takes sends them through
    the PyTorch passes (`_hubcol_*`), as JAX's XLA emulation does; the
    result is the in-kernel route's."""
    rng = np.random.default_rng(4)
    gj, gt, tb = make_inputs(rng, hubby=True)
    jd, td = _drops(dropping)
    out, grads, _ = _jax_agg(gj, tb, jd, "xla")
    in_kernel = _torch_agg(tgd.gat_dense_agg, gt, tb, td)
    monkeypatch.setattr(tgd, "GAT_MAX_HUBS", 0)
    assert not tgd._hub_in_kernel(gt.band.fwd)
    outside = _torch_agg(tgd.gat_dense_agg, gt, tb, td)
    _assert_agg(outside, (out, grads), TOL[torch.float32])
    _assert_agg(outside, ([t.detach() for t in in_kernel[0]], in_kernel[1]),
                TOL[torch.float32])


def test_plain_function_is_the_kernel_function_on_the_cpu():
    """On CPU tensors `gat_dense_agg` takes the plain versions, so it equals
    `gat_dense_agg_plain` bit for bit, and no kernel counts a launch."""
    rng = np.random.default_rng(5)
    _, gt, tb = make_inputs(rng, hubby=True)
    _, td = _drops(True)
    counts = [k.launches for k in (tgd.win_fused, tgd.win_der, tgd.win_dsend)]
    a = _torch_agg(tgd.gat_dense_agg, gt, tb, td)
    b = _torch_agg(tgd.gat_dense_agg_plain, gt, tb, td)
    for x, y in zip(list(a[0]) + list(a[1]), list(b[0]) + list(b[1])):
        assert torch.equal(x, y)
    assert [k.launches for k in (tgd.win_fused, tgd.win_der, tgd.win_dsend)] == counts


@pytest.mark.parametrize("h, want", [(1, 256), (3, 256), (4, 224), (8, 128), (16, 64), (64, 32)])
def test_k7_list_size(h, want):
    """K7's list of a row's kept positions: the most multiples of 32 entries
    whose ids, counts and per-head weights (and M and den per head) fit
    `K7_LIST_BYTES`, at least 32 and at most `K7_MAX_LIST`; eight warps'
    lists and the most hub ids a kernel takes fit a block's shared memory on
    the card. A longer row is done in chunks of this size inside the kernel."""
    size = tgd.k7_list_size(h)
    assert size == want and size % 32 == 0
    per_warp = 4 * (size * (2 + h) + 2 * h)
    assert size == 32 or per_warp <= tgd.K7_LIST_BYTES
    assert 4 * tgd.GAT_MAX_HUBS + 8 * per_warp <= 232_448


@pytest.mark.parametrize("h, d, vec, want", [(3, 128, 4, 3), (3, 256, 4, 6), (1, 40, 4, 1),
                                             (1, 256, 4, 2), (4, 256, 4, 6), (2, 41, 1, 8)])
def test_k7_layout_covers_the_row(h, d, vec, want):
    """K7's walk form: the fewest of its forms (nch groups of 32·vec columns
    a lane) that cover a row's H·D columns, or the widest, which walks a
    wider row (4 x 256) in column chunks."""
    nch, size = tgd.k7_layout(h, d, vec)
    assert nch == want and nch in tgd._K7_FORMS[vec]
    assert size == tgd.k7_list_size(h)
    assert nch * 32 * vec >= h * d or nch == max(tgd._K7_FORMS[vec])


@pytest.mark.parametrize("h, want", [(1, 256), (2, 224), (3, 160), (4, 128), (8, 64),
                                     (64, 32)])
def test_k9_list_size(h, want):
    """K9's list of a sender row's kept positions: the most multiples of 32
    entries whose ids, counts and two values a head (round(E) and E·lrelu′,
    beside d_el per head) fit `K9_LIST_BYTES`, at least 32 and at most
    `K9_MAX_LIST`; eight warps' lists and the most hub ids a kernel takes
    fit a block's shared memory on the card. A longer row is done in chunks
    of this size inside the kernel."""
    size = tgd.k9_list_size(h)
    assert size == want and size % 32 == 0
    per_warp = 4 * (size * (2 + 2 * h) + h)
    assert size == 32 or per_warp <= tgd.K9_LIST_BYTES
    assert 4 * tgd.GAT_MAX_HUBS + 8 * per_warp <= 232_448


@pytest.mark.parametrize("h, d, vec, want", [(3, 128, 4, 3), (3, 256, 4, 3), (1, 40, 4, 1),
                                             (1, 256, 4, 2), (2, 41, 1, 8), (1, 300, 1, 8)])
def test_k9_layout_covers_the_row(h, d, vec, want):
    """K9's walk form: the fewest of its forms (nch groups of 32·vec columns
    a lane) that cover a row's H·D columns, or the widest, which walks a
    wider row (3 x 256, 768 columns) in column chunks, since each column
    holds two float32 sums (d_feat and G) in registers."""
    nch, size = tgd.k9_layout(h, d, vec)
    assert nch == want and nch in tgd._K9_FORMS[vec]
    assert size == tgd.k9_list_size(h)
    assert nch * 32 * vec >= h * d or nch == max(tgd._K9_FORMS[vec])
