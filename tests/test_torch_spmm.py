"""K1/K2 and their autograd Functions: the port's plain versions against the
JAX package's Pallas kernels (interpret mode on the CPU). The CUDA kernels
against the plain versions, on the card, are in test_torch_cuda.py.

Graphs, sizes and tolerances follow tests/test_spmm_pallas.py: forward
rtol/atol 2e-5, gradients rtol 5e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.graph import build_graph
from deep_gcns_torch_tpu.ops import spmm_pallas as sp
from deep_gcns_torch_tpu_torch.graph import longest_first
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
from np_ref import random_graph, with_top_sender
from torch_budget import budget  # noqa: F401

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=1e-5)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def _graph(rng, n, e, c, node_pad, edge_pad):
    x, s, r = random_graph(rng, n, e, c)
    return build_graph(x, s, r, node_pad=node_pad, edge_pad=edge_pad)


def _power_law_graph(rng):
    """A hub receiving most edges (spans many TPU tiles) + isolated nodes."""
    n, e, c = 600, 4096, 128
    r = np.concatenate([np.zeros(2500, np.int32),
                        rng.integers(0, n // 2, e - 2500).astype(np.int32)])
    s = rng.integers(0, n, e).astype(np.int32)
    x = rng.standard_normal((n, c)).astype(np.float32)
    return build_graph(x, s, r, node_pad=640, edge_pad=4096)


def test_segment_sum_csr_forward_and_grad(rng_np):
    g = _graph(rng_np, 500, 3000, 24, 512, 3072)
    msgs = rng_np.standard_normal((g.num_edges_padded, 24)).astype(np.float32)
    co = rng_np.standard_normal((g.num_nodes_padded, 24)).astype(np.float32)
    recv, rp = jnp.asarray(g.receivers), jnp.asarray(g.row_ptr)

    def f(m):
        out = sp.segment_sum_csr(m, recv, rp, True)
        return jnp.sum(out * co), out

    (_, want), gm = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(msgs))
    m_t = _t(msgs).requires_grad_(True)
    got = tsp.segment_sum_csr(m_t, _t(g.receivers), _t(g.row_ptr))
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(m_t.grad.numpy(), np.asarray(gm), **GRAD)


@pytest.mark.parametrize("case", ["uniform", "power_law"])
def test_segment_sum_csr_gathered_form(rng_np, case):
    """K1 with the fused gather = take(q, csc_receivers) then the CSC sum, as
    the node-factored backward calls it."""
    g = (_graph(rng_np, 400, 2500, 128, 512, 3072) if case == "uniform"
         else _power_law_graph(rng_np))
    n_pad = g.num_nodes_padded
    q = rng_np.standard_normal((n_pad, 128)).astype(np.float32)
    qg = jnp.take(jnp.asarray(q), jnp.minimum(jnp.asarray(g.csc_receivers), n_pad - 1),
                  axis=0)
    want = sp.segment_sum_csr(qg, jnp.asarray(g.csc_senders), jnp.asarray(g.csc_col_ptr),
                              True)
    got = tsp.csr_seg_sum(_t(q), _t(g.csc_col_ptr), _t(g.csc_receivers))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _fused_args(g):
    return (jnp.asarray(g.senders), jnp.asarray(g.receivers), jnp.asarray(g.row_ptr),
            jnp.asarray(g.csc_senders), jnp.asarray(g.csc_receivers),
            jnp.asarray(g.csc_col_ptr))


def _port_args(g):
    rp, cp = np.asarray(g.row_ptr), np.asarray(g.csc_col_ptr)
    return (_t(g.senders), _t(rp), _t(longest_first(rp)), _t(g.csc_receivers), _t(cp),
            _t(longest_first(cp)))


@pytest.mark.parametrize("case,t", [("uniform", 0.1), ("uniform", 1.0),
                                    ("power_law", 1.0)])
def test_fused_softmax_gather_agg_forward(rng_np, case, t):
    g = (_graph(rng_np, 400, 2500, 128, 512, 3072) if case == "uniform"
         else _power_law_graph(rng_np))
    x = np.asarray(g.x, np.float32)
    want = sp.fused_softmax_gather_agg(jnp.asarray(x), *_fused_args(g), jnp.float32(t),
                                       None, None, 1e-7, False, True)
    got = tsp.fused_softmax_gather_agg(_t(x), *_port_args(g), torch.tensor([t]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("grad_weights", [False, True])
def test_fused_softmax_gather_agg_grads(rng_np, grad_weights):
    g = _graph(rng_np, 250, 1500, 128, 256, 1536)
    x = np.asarray(g.x, np.float32)
    args = _fused_args(g)

    def f(x_, t_):
        out = sp.fused_softmax_gather_agg(x_, *args, t_, None, None, 1e-7, grad_weights,
                                          True)
        return jnp.sum(out ** 2)

    gx, gt = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.float32(0.9))
    x_t = _t(x).requires_grad_(True)
    t_t = torch.tensor([0.9], requires_grad=grad_weights)
    out = tsp.fused_softmax_gather_agg(x_t, *_port_args(g), t_t, eps=1e-7,
                                       grad_weights=grad_weights)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(gx), **GRAD)
    if grad_weights:
        np.testing.assert_allclose(float(t_t.grad), float(gt), **GRAD)
    else:
        assert float(gt) == 0.0


def test_bf16_plain_rounds_like_jax(rng_np):
    """bf16 inputs: the plain K2 rounds each edge term to bf16 before the f32
    sum and returns out in bf16, as the Pallas kernel does. The graph has a
    top sender (`with_top_sender`), so each receiver's own shift is the
    Pallas kernel's global one and the terms are the same numbers."""
    x, s, r = with_top_sender(*random_graph(rng_np, 250, 1500, 128))
    g = build_graph(x, s, r, node_pad=256, edge_pad=2048)
    x = np.asarray(g.x, np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = sp.fused_softmax_gather_agg(xb, *_fused_args(g), jnp.float32(1.0), None, None,
                                       1e-7, False, True)
    got = tsp.fused_softmax_gather_agg(_t(x, torch.bfloat16), *_port_args(g),
                                       torch.tensor([1.0]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_cpu_wrappers_never_count_launches(rng_np):
    g = _graph(rng_np, 100, 500, 8, 256, 1024)
    before = (tsp.csr_seg_sum.launches, tsp.softmax_agg.launches)
    x = _t(np.asarray(g.x, np.float32))
    tsp.fused_softmax_gather_agg(x, *_port_args(g), torch.tensor([1.0]))
    tsp.csr_seg_sum(x, _t(g.csc_col_ptr), _t(g.csc_receivers))
    assert (tsp.csr_seg_sum.launches, tsp.softmax_agg.launches) == before


@pytest.mark.parametrize("h, d, vec, want", [(3, 128, 4, (3, 32, 1)), (3, 256, 4, (6, 32, 1)),
                                             (1, 40, 4, (1, 16, 2)), (2, 41, 1, (8, 32, 1)),
                                             (8, 64, 4, (6, 32, 1)), (1, 900, 4, (8, 32, 1)),
                                             (2, 8, 4, (1, 16, 2)), (4, 512, 4, (6, 32, 1))])
def test_k6_layout(h, d, vec, want):
    """K6's walk across a sender row's H·D columns in bf16: two lane groups
    of 16 for a row of at most 16·vec columns (1 x 40, nch 1); else one
    group and, of the forms that hold a whole head, the one with the fewest
    walks (3 x 128: one walk of 3 column groups; 3 x 256: one walk of 6; 4 x
    512: walks of one head in 6; a head over 768 columns: the wide form).
    Every walk holds at least one whole head, so each (edge, head) dot
    completes in one walk."""
    nch, w, groups = tsp.k6_layout(h, d, vec)
    assert (nch, w, groups) == want
    assert w * groups <= 32 and (w, groups) == tsp.k6_lane_groups(h * d, vec)
    if groups > 1:
        assert nch == 1 and w * vec >= h * d and w & (w - 1) == 0
    else:
        assert nch in tsp._K6_FORMS[vec] or nch == tsp._K6_WIDE
    assert min(h, nch, w * vec * nch // d) >= 1


@pytest.mark.parametrize("h, d, vec", [(1, 40, 4), (3, 128, 4), (2, 8, 4), (1, 12, 1)])
def test_k6_float32_takes_one_group(h, d, vec):
    """float32 K6 keeps one group at every width, so that each column and
    each head's d_el sum their edges in edge order, as the first form did."""
    nch, w, groups = tsp.k6_layout(h, d, vec, torch.float32)
    assert (w, groups) == (32, 1) and nch * 32 * vec >= d


@pytest.mark.parametrize("c, vec, dtype, want", [
    (8, 4, torch.float32, (2, 16)), (48, 4, torch.bfloat16, (12, 2)),
    (8, 4, torch.bfloat16, (2, 16)), (48, 4, torch.float32, (12, 2)),
    (64, 4, torch.bfloat16, (16, 2)), (30, 1, torch.float32, (30, 1)),
    (128, 4, torch.bfloat16, (32, 1)), (392, 4, torch.bfloat16, (32, 1)),
    (776, 4, torch.bfloat16, (32, 1)), (3, 1, torch.float32, (3, 10))])
def test_k1_layout(c, vec, dtype, want):
    """K1's lane layout: a row of at most 16 vector slots takes a group of as
    many lanes, G rows a warp (C=8 float32: 2 lanes, 16 rows; C=48 bf16: 12
    lanes, 2 rows), in both dtypes, since each group walks its own row in
    edge order; a wider row takes the whole warp. Every channel is covered
    and no warp takes more than 32 lanes."""
    w, groups = tsp.k1_layout(c, vec, dtype)
    assert (w, groups) == want
    assert w * groups <= 32 and (groups == 1 or w * vec >= c)
    assert groups == 1 or w <= 16
    # every channel lies in one of the row's slots: a group's w lanes, or a
    # warp's 32 lanes over as many slots a lane as the row needs
    slots = -(-c // vec)
    assert (w == slots) if groups > 1 else (w == min(32, slots))
