"""The port's kNN and dense neighbour gather on the CPU, against the JAX
package's (`ops/knn.py`, `ops/gather.py:100-152`).

The points are drawn so that consecutive neighbour ranks are far apart
(`_points` draws from successive seeds until they are): each test asserts `knn_rank_margin` above 1e-6 of the largest distance
(float32 distance error is ~1e-7 of it, a few ulps of the squared norms),
so the exact lists must agree id for id, whatever order `lax.top_k` and
`torch.topk` give tied entries.

Tolerances: distances 1e-5 relative (summation order only); the gathers'
forward bit for bit (a copy); their backward 1e-5 in float32 (summation
order), and in bf16 one bf16 ulp (2^-7 relative) of the largest sum, since
K1 sums in float32 and rounds once, where JAX's scatter rounds each add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.ops import gather as jgather
from deep_gcns_torch_tpu.ops import knn as jknn
from deep_gcns_torch_tpu_torch.ops import gather as tgather
from deep_gcns_torch_tpu_torch.ops import knn as tknn
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
from deep_gcns_torch_tpu_torch.utils.agreement import knn_flips, knn_rank_margin
from torch_budget import budget  # noqa: F401

MARGIN = 1e-6


def _points(seed, shape, k):
    """Uniform points from the first seed at or after ``seed`` whose k + 1
    nearest ranks are all more than MARGIN apart."""
    for s in range(seed, seed + 1000):
        x = np.random.default_rng(s).random(shape).astype(np.float32)
        if knn_rank_margin(torch.from_numpy(x), k) > MARGIN:
            return x
    raise AssertionError("no tie-free draw")


def test_pairwise_distance_matches_jax():
    x = _points(0, (2, 40, 3), 8)
    want = np.asarray(jknn.pairwise_distance(jnp.asarray(x)))
    got = tknn.pairwise_distance(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,row_block", [(60, 1024), (300, 128), (300, 64)])
def test_knn_dense_matches_jax(n, row_block):
    """Direct and row-blocked paths, id for id, self first."""
    x = _points(1, (2, n, 3), 12)
    want = np.asarray(jknn.knn_dense(jnp.asarray(x), 12, row_block=row_block))
    got = tknn.knn_dense(torch.from_numpy(x), 12, row_block=row_block)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[..., 0].numpy(), np.broadcast_to(np.arange(n), (2, n)))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_dilated_knn_graph_dense_matches_jax(d):
    x = _points(2, (2, 64, 5), 4 * d)
    want_nn, want_c = jknn.dilated_knn_graph_dense(jnp.asarray(x), 4, d)
    got_nn, got_c = tknn.dilated_knn_graph_dense(torch.from_numpy(x), 4, d)
    np.testing.assert_array_equal(got_nn.numpy(), np.asarray(want_nn))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    full = tknn.knn_dense(torch.from_numpy(x), 4 * d)
    np.testing.assert_array_equal(got_nn.numpy(), full[..., ::d].numpy())
    nn_j, c_j = jknn.knn_graph_dense(jnp.asarray(x), 4)
    nn_t, c_t = tknn.knn_graph_dense(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_stochastic_dilation_semantics():
    """ε = 1 at train time: k ranks of one permutation of range(k·d) for the
    whole batch; eval (and ε = 0) keeps the stride; a seeded generator
    repeats itself. JAX's bits differ, so the semantics are checked here."""
    x = torch.from_numpy(_points(3, (2, 48, 3), 12))
    full = tknn.knn_dense(x, 12)
    kw = dict(stochastic=True, epsilon=1.0)
    nn_t, _ = tknn.dilated_knn_graph_dense(x, 4, 3, train=True,
                                           generator=torch.Generator().manual_seed(5), **kw)
    ranks = [int((full[0, 0] == v).nonzero()) for v in nn_t[0, 0]]
    assert len(set(ranks)) == 4 and all(0 <= r < 12 for r in ranks)
    np.testing.assert_array_equal(nn_t.numpy(), full[..., ranks].numpy())
    again, _ = tknn.dilated_knn_graph_dense(x, 4, 3, train=True,
                                            generator=torch.Generator().manual_seed(5), **kw)
    np.testing.assert_array_equal(again.numpy(), nn_t.numpy())
    for train, eps in ((False, 1.0), (True, 0.0)):
        nn_e, _ = tknn.dilated_knn_graph_dense(x, 4, 3, train=train, stochastic=True,
                                               epsilon=eps, generator=torch.Generator())
        np.testing.assert_array_equal(nn_e.numpy(), full[..., ::3].numpy())


def test_dilated_knn_graph_flat_matches_jax():
    x = _points(4, (3, 32, 3), 8).reshape(96, 3)
    ws, wr = jknn.dilated_knn_graph_flat(jnp.asarray(x), 4, 2, num_nodes_per_graph=32)
    gs, gr = tknn.dilated_knn_graph_flat(torch.from_numpy(x), 4, 2, num_nodes_per_graph=32)
    assert gs.dtype == gr.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    assert np.all(np.diff(gr.numpy()) >= 0)


@pytest.mark.parametrize("n,k,d", [(64, 6, 1), (128, 5, 4), (128, 5, 3), (12, 5, 4)])
def test_approx_path_matches_jax(n, k, d):
    """The candidate subsample with self first (JAX's `approx_min_k` is
    exact on the CPU), the tiny-N fallback (⌈12/4⌉ < 5) included; self at
    rank 0, no duplicate, the others from the stride."""
    x = _points(5, (2, n, 3), k * d)
    want, _ = jknn.dilated_knn_graph_dense(jnp.asarray(x), k, d, method="approx")
    got, _ = tknn.dilated_knn_graph_dense(torch.from_numpy(x), k, d, method="approx")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = got.numpy()
    np.testing.assert_array_equal(g[..., 0], np.broadcast_to(np.arange(n), (2, n)))
    assert all(len(set(r)) == k for r in g.reshape(-1, k).tolist())
    if -(-n // d) >= k:
        assert np.all(g[..., 1:] % d == 0)


def test_approx_path_train_offset():
    """Stochastic at train time the subsample starts at an offset drawn from
    the generator: ids stay valid, distinct, with self first."""
    x = torch.from_numpy(_points(6, (1, 128, 3), 20))
    got, _ = tknn.dilated_knn_graph_dense(x, 5, 4, method="approx", train=True,
                                          stochastic=True,
                                          generator=torch.Generator().manual_seed(1))
    g = got[0].numpy()
    np.testing.assert_array_equal(g[:, 0], np.arange(128))
    assert all(len(set(r)) == 5 for r in g.tolist())
    off = g[:, 1:] % 4
    assert len(np.unique(off)) == 1


def test_self_first_matches_jax():
    idx = np.array([[[3, 0, 7, 5], [9, 4, 1, 2], [2, 8, 6, 0]]], np.int32)
    want = np.asarray(jknn._self_first(jnp.asarray(idx), 3))
    np.testing.assert_array_equal(tknn._self_first(torch.from_numpy(idx)).numpy(), want)


def test_knn_margin_and_flips():
    """`knn_rank_margin` is 0 at a tie; `knn_flips` names the row, rank and
    both ids of a swapped pair and gives their distance gap."""
    x = torch.tensor([[[0.0], [1.0], [-1.0], [3.0]]])
    assert knn_rank_margin(x, 2) == 0.0
    want = tknn.knn_dense(x, 3)
    assert knn_flips(x, want, want) == []
    got = want.clone()
    got[0, 0, 1], got[0, 0, 2] = want[0, 0, 2], want[0, 0, 1]
    (f,) = knn_flips(x, got, want)
    assert (f["batch"], f["point"], f["rank"]) == (0, 0, 1)
    assert {f["got"], f["want"]} == {1, 2} and f["rel_gap"] == 0.0


def test_neighbor_transpose_matches_jax():
    idx = np.random.default_rng(7).integers(0, 20, (3, 20, 5)).astype(np.int32)
    want = jgather.neighbor_transpose(jnp.asarray(idx))
    got = tgather.neighbor_transpose(torch.from_numpy(idx).long())
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("c", [9, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_neighbors_matches_jax(c, dtype):
    """Forward bit for bit and backward against JAX: C=40 takes the K1 route
    (held against JAX's CSC Function with `segment_sum_csr` in interpret
    mode, which asks for B·N % 128 == 0 and E % 512 == 0), C=9 the plain
    gather; a point that is no one's neighbour gets an exact 0."""
    b, n, k = 2, 64, 4
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n - 1, (b, n, k)).astype(np.int32)  # point n − 1 unused
    co = rng.standard_normal((b, n, k, c)).astype(np.float32)
    jd = jnp.dtype(dtype)
    xj, coj = jnp.asarray(x).astype(jd), jnp.asarray(co).astype(jd)
    if c >= 32:
        perm, senders, row_ptr = jgather.neighbor_transpose(jnp.asarray(idx))

        def fj(v):
            return jgather._gather_neighbors_csc(v, jnp.asarray(idx), perm, senders, row_ptr,
                                                 True)
    else:
        def fj(v):
            return jgather.gather_neighbors(v, jnp.asarray(idx))
    want, vjp = jax.vjp(fj, xj)
    (gwant,) = vjp(coj)
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    launches = tsp.csr_seg_sum.launches
    got = tgather.gather_neighbors(xt, torch.from_numpy(idx).long())
    (got * torch.from_numpy(co).to(td)).sum().backward()
    assert tsp.csr_seg_sum.launches == launches  # the CPU takes the plain version
    assert (type(got.grad_fn).__name__ == "_GatherNeighborsBackward") == (c >= 32)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    gw = np.asarray(gwant.astype(jnp.float32))
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(xt.grad.float().numpy(), gw, rtol=rtol,
                               atol=rtol * np.abs(gw).max())
    assert not xt.grad[:, n - 1].float().abs().any()
