"""The port's plain segment ops and GENConv against the JAX package and the
reference goldens (`tests/goldens/ref_genconv_*.npz`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.ops import segment as jseg
from deep_gcns_torch_tpu.ops import spmm_pallas as sp
from deep_gcns_torch_tpu_torch.convs.sparse import GENConv
from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.ops import segment as tseg
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp

AGGRS = ("softmax", "softmax_sg", "softmax_sum", "power", "power_sum", "add", "mean",
         "max", "min")
GOLDEN_AGGRS = ("softmax", "softmax_sg", "softmax_sum", "power", "power_sum", "add",
                "mean", "max")
GOLD = os.path.join(os.path.dirname(__file__), "goldens")
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=1e-5)


def _edges(seed, n=60, e=400, c=6, ties=False, node_pad=64):
    rng = np.random.default_rng(seed)
    g = jax_build_graph(None, rng.integers(0, n, e), rng.integers(0, n, e), num_nodes=n,
                        node_pad=node_pad, edge_pad=512)
    msgs = np.abs(rng.standard_normal((g.num_edges_padded, c))).astype(np.float32) + 1e-3
    if ties:
        msgs = np.round(msgs, 1)
    co = rng.standard_normal((g.num_nodes_padded, c)).astype(np.float32)
    return g, msgs, co


@pytest.mark.parametrize("aggr", AGGRS)
def test_generalized_aggregate_matches_jax(aggr):
    learn_t = aggr in ("softmax", "softmax_sum")
    g, msgs, co = _edges(1, ties=aggr in ("max", "min"))
    recv, mask, n_pad = np.asarray(g.receivers), np.asarray(g.edge_mask), g.num_nodes_padded
    scal = {"t": np.float32(1.3), "p": np.float32(1.7), "y": np.float32(0.4)}

    def f_jax(m, t, p, y):
        out = jseg.generalized_aggregate(m, jnp.asarray(recv), n_pad, aggr=aggr, t=t, p=p,
                                         y=y, learn_t=learn_t, mask=jnp.asarray(mask))
        return jnp.sum(out * co), out

    (_, want), grads = jax.value_and_grad(f_jax, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(msgs), *(jnp.asarray(v) for v in scal.values()))

    m_t = torch.from_numpy(msgs).requires_grad_(True)
    sc_t = {k: torch.tensor(v, requires_grad=True) for k, v in scal.items()}
    got = tseg.generalized_aggregate(m_t, torch.from_numpy(recv), n_pad, aggr=aggr,
                                     learn_t=learn_t, mask=torch.from_numpy(mask), **sc_t)
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(m_t.grad.numpy(), np.asarray(grads[0]), **GRAD)
    for (k, v), gj in zip(sc_t.items(), grads[1:]):
        gt = 0.0 if v.grad is None else float(v.grad)
        np.testing.assert_allclose(gt, float(gj), err_msg=k, **GRAD)


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_generalized_aggregate_csr_route_matches_jax(aggr, monkeypatch):
    """With the receivers' ``row_ptr``, add and mean go through K1's Function
    (`segment_sum_csr`, its plain version here): held against JAX's
    `generalized_aggregate` on its XLA route (masked segment sum) and against
    the JAX package's kernel route, `spmm_pallas.segment_sum_csr` in
    interpret mode (divided by the same clamped degree for mean), forward
    and gradient. The padded messages beyond ``row_ptr[-1]`` carry random
    values that neither route may read."""
    g, msgs, co = _edges(3, node_pad=128)
    recv, mask, n_pad = jnp.asarray(g.receivers), jnp.asarray(g.edge_mask), g.num_nodes_padded
    rp = jnp.asarray(g.row_ptr)

    def xla(m):
        return jseg.generalized_aggregate(m, recv, n_pad, aggr=aggr, mask=mask)

    def kernel_route(m):
        s = sp.segment_sum_csr(m, recv, rp, True)
        if aggr == "mean":
            cnt = jseg.segment_degree(recv, n_pad, mask, dtype=s.dtype)
            s = s / jnp.maximum(cnt, 1)[:, None]
        return s

    calls = []
    monkeypatch.setattr(tseg, "segment_sum_csr",
                        lambda *a: calls.append(1) or tsp.segment_sum_csr(*a))
    m_t = torch.from_numpy(msgs).requires_grad_(True)
    got = tseg.generalized_aggregate(m_t, torch.from_numpy(np.asarray(g.receivers)), n_pad,
                                     aggr=aggr, mask=torch.from_numpy(np.asarray(g.edge_mask)),
                                     row_ptr=torch.from_numpy(np.asarray(g.row_ptr)))
    (got * torch.from_numpy(co)).sum().backward()
    assert calls == [1]
    for f in (xla, kernel_route):
        want, vjp = jax.vjp(f, jnp.asarray(msgs))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
        np.testing.assert_allclose(m_t.grad.numpy(), np.asarray(vjp(jnp.asarray(co))[0]),
                                   **GRAD)


@pytest.mark.parametrize("name", ["add", "mean", "max", "min"])
def test_scatter_matches_jax(name):
    """Named dispatch on unsorted ids with masked entries, forward and grad."""
    rng = np.random.default_rng(2)
    data = np.round(rng.standard_normal((300, 5)), 1).astype(np.float32)
    ids = rng.integers(0, 40, 300).astype(np.int32)
    ids[:10] = 40  # out of range: dropped
    mask = rng.random(300) < 0.8
    co = rng.standard_normal((40, 5)).astype(np.float32)

    def f(d):
        out = jseg.scatter(name, d, jnp.asarray(ids), 40, jnp.asarray(mask),
                           indices_are_sorted=False)
        return jnp.sum(out * co), out

    (_, want), gwant = jax.value_and_grad(f, has_aux=True)(jnp.asarray(data))
    d_t = torch.from_numpy(data).requires_grad_(True)
    got = tseg.scatter(name, d_t, torch.from_numpy(ids), 40, torch.from_numpy(mask))
    (got * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(gwant), **GRAD)


def _load(name):
    z = np.load(os.path.join(GOLD, f"ref_{name}.npz"))
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    gd = {k[3:]: z[k] for k in z.files if k.startswith("gd.")}
    return z, sd, gd


@pytest.mark.parametrize("aggr", GOLDEN_AGGRS)
def test_genconv_reference_golden(aggr):
    z, sd, gd = _load(f"genconv_{aggr}")
    ei = z["edge_index"]
    g = build_graph(z["x"], ei[0], ei[1], num_nodes=z["x"].shape[0])
    conv = GENConv(16, 16, aggr=aggr, learn_t=True, learn_p=True, learn_y=True,
                   norm="batch", mlp_layers=2)
    conv.load_state_dict(sd)
    conv.train()
    x = g.x.clone().requires_grad_(True)
    n = z["co"].shape[0]
    out = conv(x, g)
    (out[:n] * torch.from_numpy(z["co"])).sum().backward()
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out[:n].detach().numpy(), z["out"], err_msg="out", **tol)
    np.testing.assert_allclose(x.grad[:n].numpy(), z["gx"], err_msg="gx", **tol)
    params = dict(conv.named_parameters())
    assert set(params) == set(gd)
    for k, want in gd.items():
        np.testing.assert_allclose(params[k].grad.numpy(), want, err_msg=k, **tol)


def test_genconv_rejects_edge_features():
    """Raw edge features of another width than the nodes' need an edge
    encoder; the bond encoder needs its feature dimensions (it is held
    against JAX in `tests/test_torch_ogbg.py`)."""
    rng = np.random.default_rng(0)
    g = build_graph(rng.standard_normal((8, 4)).astype(np.float32), np.arange(8),
                    np.arange(8), edge_attr=np.ones((8, 2), np.float32))
    with pytest.raises(ValueError):
        GENConv(4, 4)(g.x, g)
    with pytest.raises(ValueError):
        GENConv(4, 4, encode_edge=True, bond_encoder=True)
    bond = GENConv(4, 4, encode_edge=True, bond_encoder=True, bond_feature_dims=(5, 6))
    assert bond(g.x, g.replace(edge_attr=torch.ones((g.num_edges_padded, 2),
                                                    dtype=torch.int32))).shape == (256, 4)
    assert GENConv(4, 4, encode_edge=True, edge_feat_dim=2)(g.x, g).shape == (256, 4)
