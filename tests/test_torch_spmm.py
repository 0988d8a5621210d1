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
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
from np_ref import random_graph

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

    (_, want), gm = jax.value_and_grad(f, has_aux=True)(jnp.asarray(msgs))
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
    return (_t(g.senders), _t(g.row_ptr), _t(g.csc_receivers), _t(g.csc_col_ptr))


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

    gx, gt = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.float32(0.9))
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
    sum and returns out and den in bf16, as the Pallas kernel does."""
    g = _graph(rng_np, 250, 1500, 128, 256, 1536)
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
