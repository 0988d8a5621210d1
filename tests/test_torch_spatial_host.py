"""The parallel layer's host side and single-process pieces against the JAX
package: `shard_graph` array for array (D = 2, 3, 8, with and without edge
features, with the local bands), `generalized_aggregate_split` for every
aggregator in values and gradients, and the launcher's failure handling
(a rank that raises, a rank that never joins a collective)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as tpc
from deep_gcns_torch_tpu.ops.segment import \
    generalized_aggregate_split as jax_split
from deep_gcns_torch_tpu.parallel.spatial import shard_graph as jax_shard_graph
from deep_gcns_torch_tpu.parallel.spatial import shard_nodes as jax_shard_nodes
from deep_gcns_torch_tpu_torch.ops.segment import generalized_aggregate_split
from deep_gcns_torch_tpu_torch.parallel import launch
from deep_gcns_torch_tpu_torch.parallel.launch import RankFailed
from deep_gcns_torch_tpu_torch.parallel.spatial import shard_graph, shard_nodes
from torch_budget import budget  # noqa: F401

FIELDS = ("senders", "receivers", "edge_attr", "edge_mask", "row_ptr", "node_mask",
          "senders_ext", "loc_senders", "loc_receivers", "loc_row_ptr", "loc_edge_attr",
          "halo_senders", "halo_receivers", "halo_row_ptr", "halo_edge_attr")
BAND_ARRAYS = ("w_lo", "a", "lo_src", "lo_dst", "lo_row_ptr", "hub_ids", "a_hub",
               "hub_row_ids", "a_row", "a_t", "a_hub_t")
BAND_STATIC = ("window", "n_edges", "n_lo", "n_hub", "n_hub_row")


def _graph(n, e, edge_dim, seed=0, local=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.clip(s + rng.integers(-60, 61, e), 0, n - 1) if local else rng.integers(0, n, e)
    ea = rng.standard_normal((e, edge_dim)).astype(np.float32) if edge_dim else None
    return s, r, ea


def _same(name, got, want):
    if want is None:
        assert got is None, name
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("d,edge_dim", [(2, 0), (3, 6), (8, 0), (8, 6)])
def test_shard_graph_matches_jax(d, edge_dim):
    n = 900
    s, r, ea = _graph(n, 5000, edge_dim)
    got = shard_graph(s, r, n, d, edge_attr=ea)
    want = jax_shard_graph(s, r, n, d, edge_attr=ea)
    for f in FIELDS:
        _same(f, getattr(got, f), getattr(want, f))
    assert len(got.send_off) == len(want.send_off) == d - 1
    for k, (a, b) in enumerate(zip(got.send_off, want.send_off)):
        _same(f"send_off[{k}]", a, b)
    assert (got.shard_size, got.num_nodes_padded, got.off_pads) == \
        (want.shard_size, want.num_nodes_padded, want.off_pads)
    assert got.halo_rows_per_device == want.halo_rows_per_device
    x = np.random.default_rng(1).standard_normal((n, 5)).astype(np.float32)
    np.testing.assert_array_equal(shard_nodes(x, got), jax_shard_nodes(x, want))


@pytest.mark.parametrize("d,local", [(2, True), (3, False)])
def test_shard_graph_band_matches_jax(d, local):
    """The spatial × band arrays: each rank's local band (forward and
    transpose) equals JAX's stacked one at that rank."""
    n = 1500
    s, r, _ = _graph(n, 9000, 0, seed=2, local=local)
    got = shard_graph(s, r, n, d, band="auto")
    want = jax_shard_graph(s, r, n, d, band="auto")
    assert len(got.loc_band) == d
    for rank in range(d):
        for side in ("fwd", "bwd"):
            gb, wb = getattr(got.loc_band[rank], side), getattr(want.loc_band, side)
            for f in BAND_ARRAYS:
                wa = getattr(wb, f)
                _same(f"{side}.{f}[{rank}]", getattr(gb, f),
                      None if wa is None else np.asarray(wa)[rank])
            for f in BAND_STATIC:
                assert getattr(gb, f) == getattr(wb, f), (side, f)


def test_shard_graph_single_rank_has_no_halo():
    s, r, _ = _graph(300, 1200, 0)
    got, want = shard_graph(s, r, 300, 1), jax_shard_graph(s, r, 300, 1)
    assert got.send_off is None and want.send_off is None and got.off_pads == ()
    for f in ("senders", "receivers", "row_ptr", "node_mask"):
        _same(f, getattr(got, f), getattr(want, f))


SPLIT_AGGRS = [("sum", False), ("mean", False), ("max", False), ("min", False),
               ("softmax", False), ("softmax", True), ("softmax_sg", False),
               ("softmax_sum", True), ("power", False), ("power_sum", False)]


def _split_parts(rng, n, c):
    """Two receiver-sorted edge sets over n segments (some segments in one
    part only, some in none), sentinel-padded, with their CSRs."""
    parts = []
    for e, pad in ((700, 1024), (300, 512)):
        r = np.sort(rng.integers(0, n - 20, e)).astype(np.int32)
        rp = np.zeros(n + 1, np.int32)
        np.cumsum(np.bincount(r, minlength=n), out=rp[1:])
        rr = np.full(pad, n, np.int32)
        rr[:e] = r
        m = np.zeros((pad, c), np.float32)
        m[:e] = rng.random((e, c)).astype(np.float32) * 2.0 + 0.05
        parts.append((m, rr, rp))
    return parts


@pytest.mark.parametrize("aggr,learn", SPLIT_AGGRS)
def test_generalized_aggregate_split_matches_jax(aggr, learn):
    """Values and the gradients of the messages, t, p and y (each where the
    aggregator reads it) against JAX's split aggregation."""
    n, c = 200, 32
    rng = np.random.default_rng(3)
    parts = _split_parts(rng, n, c)
    co = rng.standard_normal((n, c)).astype(np.float32)
    t0, p0, y0 = 0.7, 1.5, 0.3

    def jloss(ms, t, p, y):
        out = jax_split([(m, jnp.asarray(r), jnp.asarray(rp), None)
                         for m, (_, r, rp) in zip(ms, parts)], n, aggr=aggr, t=t, p=p, y=y,
                        learn_t=learn)
        return jnp.sum(out * co), out

    jms = [jnp.asarray(m) for m, _, _ in parts]
    jt, jp, jy = (jnp.asarray([v], jnp.float32) for v in (t0, p0, y0))
    (_, want), grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        jms, jt, jp, jy)

    tms = [torch.from_numpy(m).requires_grad_(True) for m, _, _ in parts]
    tt, tp, ty = (torch.tensor([v], requires_grad=True) for v in (t0, p0, y0))
    out = generalized_aggregate_split(
        [(m, torch.from_numpy(r), torch.from_numpy(rp), None)
         for m, (_, r, rp) in zip(tms, parts)], n, aggr=aggr, t=tt, p=tp, y=ty,
        learn_t=learn)
    (out * torch.from_numpy(co)).sum().backward()
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    for k, (tm, jg) in enumerate(zip(tms, grads[0])):
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jg), err_msg=f"msgs[{k}]",
                                   rtol=2e-4, atol=2e-5)
    for name, tg, jg in (("t", tt, grads[1]), ("p", tp, grads[2]), ("y", ty, grads[3])):
        jg = np.asarray(jg)
        if tg.grad is None:
            assert not np.any(jg), name
        else:
            np.testing.assert_allclose(tg.grad.numpy(), jg, err_msg=name, rtol=2e-4,
                                       atol=2e-5 * max(1.0, float(np.abs(jg).max())))


def test_launch_reports_the_failing_rank():
    with pytest.raises(RankFailed, match=r"rank 1 of 2 failed(.|\n)*ValueError: rank one broke"):
        launch(tpc.run_cases, 2, ([dict(kind="raise", rank=1, message="rank one broke")],),
               deadline=60)


def test_launch_deadline_ends_a_rank_that_never_joins():
    """Rank 1 never joins rank 0's all-reduce: the launch fails within its
    deadline (rank 0's collective times out, or the launcher kills both)."""
    t0 = time.monotonic()
    with pytest.raises((RankFailed, TimeoutError)):
        launch(tpc.run_cases, 2, ([dict(kind="hang", sleep=600)],), deadline=12)
    assert time.monotonic() - t0 < 45
