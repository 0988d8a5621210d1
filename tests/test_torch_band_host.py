"""The port's band host side against the JAX package's, on the same numpy
inputs: `build_band_pair` arrays bit for bit, the reorder permutations, the
power-law generator, the drop hash and the native library against its numpy
fallback. The graphs are those of tests/test_band.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.data.reorder as jreorder
import deep_gcns_torch_tpu.data.synthetic as jsyn
import deep_gcns_torch_tpu.graph as jgraph
import deep_gcns_torch_tpu.native as jnative
import deep_gcns_torch_tpu.ops.band as jband
import deep_gcns_torch_tpu_torch.data.reorder as treorder
import deep_gcns_torch_tpu_torch.data.synthetic as tsyn
import deep_gcns_torch_tpu_torch.graph as tgraph
import deep_gcns_torch_tpu_torch.native as tnative
import deep_gcns_torch_tpu_torch.ops.band as tband
from torch_budget import budget  # noqa: F401

BN = 128
ARRAYS = ("w_lo", "a", "lo_src", "lo_dst", "lo_row_ptr", "hub_ids", "a_hub", "hub_row_ids",
          "a_row", "a_t", "a_hub_t")
STATIC = ("window", "n_edges", "n_lo", "n_hub", "n_hub_row")


def banded_graph(rng, n, deg, bandwidth):
    s = rng.integers(0, n, n * deg)
    r = np.clip(s + rng.integers(-bandwidth, bandwidth + 1, n * deg), 0, n - 1)
    return s, r


def powerlaw_graph(rng, n, deg, alpha=0.9, bandwidth=200):
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** alpha
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-bandwidth, bandwidth + 1, n * deg), 0, n - 1)
    cross = rng.random(n * deg) < 0.3
    r[cross] = rng.integers(0, n, int(cross.sum()))
    return s, r


def saturated_graph(rng):
    """> 127 copies of one edge into a hub receiver, and a hub sender."""
    n = 2 * BN
    s = np.concatenate([np.full(300, 3), rng.integers(0, n, 800), np.full(400, 7)])
    r = np.concatenate([np.full(300, 5), np.full(800, 5), rng.integers(0, n, 400)])
    return n, s, r


def make_graph(case):
    rng = np.random.default_rng(0)
    if case == "tight":
        return (8 * BN,) + banded_graph(rng, 8 * BN, 6, 100)
    if case == "wide":
        return (8 * BN,) + banded_graph(rng, 8 * BN, 6, 900)
    if case == "powerlaw":
        return (8 * BN,) + powerlaw_graph(rng, 8 * BN, 8)
    if case == "saturated":
        return saturated_graph(rng)
    return (BN,) + banded_graph(rng, BN, 4, 50)  # small: the window clamps


def assert_same_band(jb, tb):
    for f in ARRAYS:
        want, got = getattr(jb, f), getattr(tb, f)
        if want is None:
            assert got is None, f
            continue
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in STATIC:
        assert getattr(tb, f) == getattr(jb, f), f


@pytest.mark.parametrize("case", ["tight", "wide", "powerlaw", "saturated", "small"])
@pytest.mark.parametrize("window", [256, 512, "auto"])
@pytest.mark.parametrize("hubs", [None, 64, "auto"])
def test_build_band_pair_bit_identical(case, window, hubs):
    n, s, r = make_graph(case)
    jp = jband.build_band_pair(s, r, n, window, hubs)
    tp = tband.build_band_pair(s, r, n, window, hubs)
    assert_same_band(jp.fwd, tp.fwd)
    assert_same_band(jp.bwd, tp.bwd)
    if case == "small":
        assert tp.fwd.window == n
    if case == "saturated" and hubs == 64:
        assert tp.fwd.n_lo > 0 and tp.fwd.hub_row_ids is not None


def test_hub_and_leftover_cases_engage():
    """The cases above reach every structure: hub columns and rows, a
    leftover in both directions, and a saturation spill."""
    n, s, r = make_graph("powerlaw")
    hubby = tband.build_band_pair(s, r, n, 256, 64)
    assert hubby.fwd.hub_ids is not None and hubby.bwd.hub_row_ids is not None
    assert hubby.fwd.n_lo > 0 and hubby.bwd.n_lo > 0
    n, s, r = make_graph("wide")
    assert 0.0 < tband.build_band_pair(s, r, n, 256, None).fwd.coverage < 1.0


@pytest.mark.parametrize("case", ["wide", "powerlaw", "saturated"])
def test_numpy_fallback_matches_native(monkeypatch, case):
    """The port's numpy band builder against its native one, and against
    the JAX package's numpy builder."""
    assert tnative.available()
    n, s, r = make_graph(case)
    native_pair = tband.build_band_pair(s, r, n, "auto", 64)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    assert not tnative.available()
    numpy_pair = tband.build_band_pair(s, r, n, "auto", 64)
    jax_numpy_pair = jband.build_band_pair(s, r, n, "auto", 64)
    for d in ("fwd", "bwd"):
        assert_same_band(getattr(jax_numpy_pair, d), getattr(numpy_pair, d))
        for f in ARRAYS:
            want, got = getattr(getattr(native_pair, d), f), getattr(getattr(numpy_pair, d), f)
            assert (want is None) == (got is None), f
            if want is not None:
                assert torch.equal(got, want), f


def _community_graph(seed=0, n=3000):
    s, r = jsyn.powerlaw_community_edges(np.random.default_rng(seed), n, 6, n_comm=16)
    return s, r, n


@pytest.mark.parametrize("order", ["rcm", "cluster"])
def test_reorder_permutations_identical(order):
    s, r, n = _community_graph()
    if order == "rcm":
        want, got = jreorder.rcm_order(s, r, n), treorder.rcm_order(s, r, n)
    else:
        want = jreorder.cluster_order(s, r, n, cluster_size=512)
        got = treorder.cluster_order(s, r, n, cluster_size=512)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("order", ["rcm", "cluster"])
def test_reorder_numpy_fallbacks_identical(order):
    s, r, n = _community_graph(seed=1, n=600)
    if order == "rcm":
        want, got = jreorder._rcm_numpy(s, r, n), treorder._rcm_numpy(s, r, n)
    else:
        want = jreorder._cluster_numpy(s, r, n, 128)
        got = treorder._cluster_numpy(s, r, n, 128)
    np.testing.assert_array_equal(got, want)


def test_reorder_without_native_takes_numpy(monkeypatch):
    s, r, n = _community_graph(seed=2, n=400)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    np.testing.assert_array_equal(treorder.cluster_order(s, r, n, 64),
                                  jreorder._cluster_numpy(s, r, n, 64))
    np.testing.assert_array_equal(treorder.rcm_order(s, r, n), jreorder._rcm_numpy(s, r, n))


def test_permute_and_bandwidth_identical():
    s, r, n = _community_graph(seed=3, n=500)
    x = np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)
    perm = jreorder.cluster_order(s, r, n, 128)
    want = jreorder.permute_graph(perm, s, r, x, None)
    got = treorder.permute_graph(perm, s, r, x, None)
    for a, b in zip(got, want):
        assert (a is None and b is None) or np.array_equal(a, b)
    np.testing.assert_array_equal(treorder.invert_permutation(perm),
                                  jreorder.invert_permutation(perm))
    assert treorder.bandwidth_stats(got[0], got[1]) == jreorder.bandwidth_stats(want[0],
                                                                               want[1])


def test_powerlaw_community_edges_identical():
    want = jsyn.powerlaw_community_edges(np.random.default_rng(7), 5000, 9)
    got = tsyn.powerlaw_community_edges(np.random.default_rng(7), 5000, 9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("thresh", [0, 1, 644245094, 2147483647])
def test_hash_keep_bit_identical(thresh):
    """Random int32 planes, keys and ids near ±2³¹ (the products wrap, the
    shifts are logical)."""
    rng = np.random.default_rng(thresh % 97)
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 30, -2 ** 30], np.int32)
    recv = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64), edge,
                           edge]).astype(np.int32)
    send = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64), edge,
                           edge[::-1]]).astype(np.int32)
    for k0, k1 in [(0, 0), (-1, 2 ** 31 - 1), (-2 ** 31, 12345),
                   tuple(int(v) for v in rng.integers(-2 ** 31, 2 ** 31, 2))]:
        want = np.asarray(jband._hash_keep(jnp.asarray(recv), jnp.asarray(send), jnp.int32(k0),
                                           jnp.int32(k1), thresh))
        got = tband._hash_keep(torch.from_numpy(recv), torch.from_numpy(send), k0, k1, thresh)
        np.testing.assert_array_equal(got.numpy(), want)
        got_t = tband._hash_keep(torch.from_numpy(recv), torch.from_numpy(send),
                                 torch.tensor(k0, dtype=torch.int32),
                                 torch.tensor(k1, dtype=torch.int32), thresh)
        np.testing.assert_array_equal(got_t.numpy(), want)


def test_edge_keep_mask_and_drop_thresh():
    rng = np.random.default_rng(5)
    recv, send = rng.integers(0, 10_000, 3000), rng.integers(0, 10_000, 3000)
    assert tband.drop_thresh(0.3) == jband.drop_thresh(0.3)
    assert tband.drop_thresh(1.0) == jband.drop_thresh(1.0)
    jd = jband.DropSpec(k0=jnp.int32(11), k1=jnp.int32(-7), thresh=jband.drop_thresh(0.3))
    td = tband.DropSpec(k0=11, k1=-7, thresh=tband.drop_thresh(0.3))
    want = np.asarray(jband.edge_keep_mask(jd, jnp.asarray(recv), jnp.asarray(send)))
    got = tband.edge_keep_mask(td, torch.from_numpy(recv), torch.from_numpy(send))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.6 < float(got.mean()) < 0.8
    assert tband.edge_keep_mask(None, torch.zeros(3), torch.zeros(3)) is None


def test_attach_band_on_graph_matches_jax_and_moves():
    rng = np.random.default_rng(6)
    n = 300
    s, r = banded_graph(rng, n, 5, 60)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    jg = jgraph.attach_band(jgraph.build_graph(x, s, r, num_nodes=n), window=512)
    tg = tgraph.attach_band(tgraph.build_graph(x, s, r, num_nodes=n), window=512)
    assert_same_band(jg.band.fwd, tg.band.fwd)
    assert_same_band(jg.band.bwd, tg.band.bwd)
    assert tg.band.fwd.coverage == jg.band.fwd.coverage > 0.9
    moved = tg.to("cpu")
    assert moved.band is not tg.band and torch.equal(moved.band.fwd.a, tg.band.fwd.a)
    assert tg.replace(band=None).band is None and tg.replace(band=None).to("cpu").band is None
    # the transposed tiles stay on the host and out of the device bytes
    assert moved.band.fwd.a_t is tg.band.fwd.a_t and "a_t" not in tg.band.fwd.tensors()
    assert tg.band.nbytes() == sum(getattr(b, f).numel() * getattr(b, f).element_size()
                                   for b in (tg.band.fwd, tg.band.bwd)
                                   for f in ARRAYS[:-2] if getattr(b, f) is not None)


def test_gates_follow_coverage_only(monkeypatch):
    rng = np.random.default_rng(8)
    n = 300
    s, r = banded_graph(rng, n, 5, 60)
    g = tgraph.attach_band(tgraph.build_graph(None, s, r, num_nodes=n), window=512)
    assert tband.band_ok(g, "mean") and tband.band_ok(g, "softmax_sg")
    assert tband.band_ok(g, "power_sum") and not tband.band_ok(g, "max")
    assert not tband.band_ok(g.replace(band=None), "softmax_sg")
    assert tband.MIN_COVERAGE == 0.5
    monkeypatch.setattr(tband, "MIN_COVERAGE", 1.01)
    assert not tband.band_sum_ok(g) and not tband.band_ok(g, "mean")


def test_converted_hub_counts_are_kept_per_band(monkeypatch):
    """`to` holds the hub count matrices in the dtype `HUB_COUNTS_DTYPE`
    names for the device type (bf16 on the card; here the CPU stands in):
    exact counts, the window counts stay int8, the band products are
    unchanged."""
    n, s, r = make_graph("powerlaw")
    pair = tband.build_band_pair(s, r, n, 256, 64)
    assert tband.HUB_COUNTS_DTYPE == {"cuda": torch.bfloat16}
    assert pair.to("cpu").fwd.a_hub.dtype == torch.int8
    monkeypatch.setattr(tband, "HUB_COUNTS_DTYPE", {"cpu": torch.bfloat16})
    moved = pair.to("cpu")
    for d in ("fwd", "bwd"):
        src, dst = getattr(pair, d), getattr(moved, d)
        for f in ("a_hub", "a_row"):
            assert getattr(dst, f).dtype == torch.bfloat16, (d, f)
            assert torch.equal(getattr(dst, f).float(), getattr(src, f).float()), (d, f)
        assert dst.a.dtype == torch.int8
    assert moved.nbytes() > pair.nbytes()
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((n, 16)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(tband.band_spmm(x.to(dtype), moved),
                           tband.band_spmm(x.to(dtype), pair))
