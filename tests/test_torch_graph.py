"""The port's graph builders against the JAX package's: bit-identical arrays.

The JAX builder sorts with its C++ counting sort (`native/`) where that
library builds, so these tests also hold that sort to the port's numpy
stable argsort."""

import numpy as np
import pytest

import deep_gcns_torch_tpu.graph as jg
import deep_gcns_torch_tpu.data.synthetic as jsyn
import deep_gcns_torch_tpu_torch.graph as tg
import deep_gcns_torch_tpu_torch.data.synthetic as tsyn
from torch_budget import budget  # noqa: F401

FIELDS = ("x", "senders", "receivers", "edge_attr", "node_mask", "edge_mask",
          "node_graph", "row_ptr", "csc_perm", "csc_senders", "csc_col_ptr",
          "csc_receivers", "edge_attr_csc")


def assert_same_graph(jax_g, torch_g):
    for f in FIELDS:
        a, b = getattr(jax_g, f), getattr(torch_g, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(jax_g.n_node) == torch_g.n_node
    assert int(jax_g.n_edge) == torch_g.n_edge
    assert jax_g.num_graphs == torch_g.num_graphs


@pytest.mark.parametrize("edge_dim", [0, 5])
def test_build_graph_bit_identical(edge_dim):
    rng = np.random.default_rng(3)
    n, e = 300, 2000
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    x = rng.standard_normal((n, 7)).astype(np.float32)
    ea = rng.standard_normal((e, edge_dim)).astype(np.float32) if edge_dim else None
    assert_same_graph(jg.build_graph(x, s, r, edge_attr=ea, num_nodes=n),
                      tg.build_graph(x, s, r, edge_attr=ea, num_nodes=n))


def test_batch_graphs_bit_identical():
    rng = np.random.default_rng(4)
    graphs = []
    for n in (13, 40, 7):
        e = 3 * n
        graphs.append({"x": rng.standard_normal((n, 4)).astype(np.float32),
                       "senders": rng.integers(0, n, e),
                       "receivers": rng.integers(0, n, e),
                       "edge_attr": rng.standard_normal((e, 2)).astype(np.float32)})
    assert_same_graph(jg.batch_graphs(graphs), tg.batch_graphs(graphs))


def test_self_loops_and_undirected_identical():
    rng = np.random.default_rng(5)
    s, r = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    for a, b in zip(jg.add_self_loops(s, r, 50), tg.add_self_loops(s, r, 50)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jg.to_undirected(s, r), tg.to_undirected(s, r)):
        np.testing.assert_array_equal(a, b)


def test_random_node_graph_identical():
    kw = dict(n=400, avg_degree=6, c=16, num_classes=5, self_loops=True)
    gj, lj = jsyn.random_node_graph(np.random.default_rng(0), **kw)
    gt, lt = tsyn.random_node_graph(np.random.default_rng(0), **kw)
    assert_same_graph(gj, gt)
    np.testing.assert_array_equal(lj, lt)


def test_sbm_arxiv_like_identical():
    gj, lj = jsyn.sbm_arxiv_like(np.random.default_rng(1), n=600, num_classes=6, c=8)
    gt, lt = tsyn.sbm_arxiv_like(np.random.default_rng(1), n=600, num_classes=6, c=8)
    assert_same_graph(gj, gt)
    np.testing.assert_array_equal(lj, lt)


def test_graph_to_cpu_keeps_arrays():
    g = tg.build_graph(None, np.array([0, 1]), np.array([1, 0]), num_nodes=2)
    h = g.to("cpu")
    assert h.n_node == 2 and h.row_ptr.dtype == g.row_ptr.dtype
    np.testing.assert_array_equal(h.csc_col_ptr.numpy(), g.csc_col_ptr.numpy())


@pytest.mark.parametrize("with_csc", [False, True])
def test_rows_longest_first_beside_each_pointer_array(with_csc):
    """`row_order` and `csc_order` (the order in which K2 and K4 hand rows to
    warps) are permutations of the rows by decreasing length, ties in index
    order, and exist exactly where their pointer array does."""
    rng = np.random.default_rng(5)
    n, e = 300, 2000
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    s[:200], r[200:500] = 7, 11  # a hub sender and a hub receiver
    g = tg.build_graph(None, s, r, num_nodes=n, with_csc=with_csc)
    pairs = [(g.row_ptr, g.row_order), (g.csc_col_ptr, g.csc_order)]
    for ptr, order in pairs if with_csc else pairs[:1]:
        ptr, order = ptr.numpy(), order.numpy()
        assert order.dtype == np.int32 and order.shape == (ptr.shape[0] - 1,)
        lengths = np.diff(ptr)[order]
        assert (np.diff(lengths) <= 0).all()
        for k in np.unique(lengths):  # ties in index order
            assert (np.diff(order[lengths == k]) > 0).all()
        assert sorted(order) == list(range(ptr.shape[0] - 1))
    assert int(g.row_order[0]) == 11
    if not with_csc:
        assert g.csc_col_ptr is None and g.csc_order is None
    else:
        assert int(g.csc_order[0]) == 7


def _long_row_graph(lengths, n=400, e=1500, seed=6, **kw):
    """Short random rows over nodes 50.., plus node i receiving exactly
    ``lengths[i]`` edges."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.repeat(np.arange(len(lengths)), lengths), rng.integers(50, n, e)])
    s = rng.integers(0, n, r.shape[0])
    return tg.build_graph(None, s, r, num_nodes=n, **kw)


@pytest.mark.parametrize("lengths", [[], [128], [129], [127, 128, 129, 5000],
                                     [300, 0, 129, 1000, 2]])
def test_split_rows_are_the_long_prefix_of_row_order(lengths):
    """`split_rows` counts the rows of more than K2_SPLIT_EDGES edges, and
    `row_order` puts exactly those first: K2 splits its first split_rows."""
    from deep_gcns_torch_tpu_torch.ops.spmm_cuda import K2_SPLIT_EDGES

    g = _long_row_graph(lengths)
    counts = np.diff(g.row_ptr.numpy())
    k = int((counts > K2_SPLIT_EDGES).sum())
    assert g.split_rows == k == sum(v > K2_SPLIT_EDGES for v in lengths)
    order = g.row_order.numpy()
    assert (counts[order[:k]] > K2_SPLIT_EDGES).all()
    assert (counts[order[k:]] <= K2_SPLIT_EDGES).all()


@pytest.mark.parametrize("case", ["short_rows", "no_edges", "no_row_ptr"])
def test_split_rows_zero_without_a_long_row(case):
    if case == "short_rows":
        g = _long_row_graph([128, 100])
    elif case == "no_edges":
        g = tg.build_graph(None, np.zeros(0, int), np.zeros(0, int), num_nodes=10)
        assert g.n_edge == 0 and g.row_ptr is not None
    else:
        g = _long_row_graph([500], with_row_ptr=False)
        assert g.row_ptr is None
    assert g.split_rows == 0


def test_split_rows_survive_to_and_batching():
    """The count travels with the graph to a device and is the batch's own
    when graphs are batched (rows of 200 and 129 edges, one of 60)."""
    g = _long_row_graph([200, 60])
    assert g.split_rows == 1 and g.to("cpu").split_rows == 1
    rng = np.random.default_rng(7)
    parts = [{"num_nodes": 300, "receivers": np.repeat([3, 4], [200, 129]),
              "senders": rng.integers(0, 300, 329)},
             {"num_nodes": 40, "receivers": np.full(60, 2), "senders": rng.integers(0, 40, 60)},
             {"num_nodes": 500, "receivers": np.full(140, 499),
              "senders": rng.integers(0, 500, 140)}]
    b = tg.batch_graphs(parts)
    assert b.split_rows == 3 and b.to("cpu").split_rows == 3
    assert sorted(b.row_order[:3].tolist()) == [3, 4, 340 + 499]
