"""The port's DeeperGCN against the JAX package's on carried-across weights
(logits, new BatchNorm state, every parameter gradient, one Adam step), and
against the reference golden `ref_deepergcn2.npz`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_gcns_torch_tpu.data.synthetic import random_node_graph as jax_random_graph
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu_torch.data.synthetic import random_node_graph
from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig
from deep_gcns_torch_tpu_torch.utils.import_jax import deeper_gcn_state_dict_from_jax
from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer
from torch_budget import budget  # noqa: F401

# f32 on both sides; the difference is summation order through 4 layers
TOL = dict(rtol=1e-4, atol=1e-4)
GOLD = os.path.join(os.path.dirname(__file__), "goldens")
# mean and add take K1's route (`segment_sum_csr` over the graph's row_ptr,
# the gather's backward over its CSC ranges), JAX its XLA route on the CPU
CASES = [("res+", "softmax_sg", False), ("res+", "softmax", True),
         ("res", "softmax_sg", False), ("res", "softmax", True),
         ("res+", "mean", False), ("res+", "add", False)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("block,aggr,learn_t", CASES)
def test_deeper_gcn_matches_jax(block, aggr, learn_t):
    kw = dict(in_channels=16, hidden_channels=32, num_tasks=7, num_layers=4, block=block,
              aggr=aggr, t=0.5, learn_t=learn_t, norm="batch", mlp_layers=1, dropout=0.0)
    jcfg, tcfg = JaxConfig(**kw), DeeperGCNConfig(**kw)
    gj, _ = jax_random_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    gt, _ = random_node_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    co = np.random.default_rng(1).standard_normal((gj.num_nodes_padded, 7)).astype(np.float32)
    co[300:] = 0.0

    jmodel = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))

    def loss_j(p):
        logits, ns = jmodel.apply(p, state, jnp.asarray(gj.x), gj, train=True)
        return jnp.sum(logits * co), (logits, ns)

    (_, (logits_j, ns_j)), gp_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)

    model = DeeperGCN(tcfg)
    model.load_state_dict(deeper_gcn_state_dict_from_jax(_np_tree(params), _np_tree(state),
                                                         jcfg))
    model.train()
    opt = make_optimizer("adam", model.parameters(), 1e-2)
    logits_t = model(gt.x, gt)
    (logits_t * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **TOL)

    want_state = deeper_gcn_state_dict_from_jax(_np_tree(params), _np_tree(ns_j), jcfg)
    want_grad = deeper_gcn_state_dict_from_jax(_np_tree(gp_j), _np_tree(ns_j), jcfg)
    for k, buf in model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_state[k].numpy(), err_msg=k, **TOL)
    named = dict(model.named_parameters())
    assert set(named) <= set(want_grad)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grad[k].numpy(), err_msg=k, **TOL)

    # one Adam step from the SAME gradients: a bias that feeds a BatchNorm has
    # a true gradient of 0, and Adam's first step turns the noise-level
    # difference between the two gradients into ±lr
    tx = optax.adam(1e-2)
    upd, _ = tx.update(gp_j, tx.init(params), params)
    want_new = deeper_gcn_state_dict_from_jax(
        _np_tree(optax.apply_updates(params, upd)), _np_tree(ns_j), jcfg)
    for k, p in named.items():
        p.grad = want_grad[k].clone()
    opt.step()
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want_new[k].numpy(), err_msg=k,
                                   **TOL)


def test_deepergcn2_reference_golden():
    z = np.load(os.path.join(GOLD, "ref_deepergcn2.npz"))
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    gd = {k[3:]: z[k] for k in z.files if k.startswith("gd.")}
    ei = z["edge_index"]
    g = build_graph(z["x"], ei[0], ei[1], num_nodes=z["x"].shape[0])
    model = DeeperGCN(DeeperGCNConfig(
        in_channels=16, hidden_channels=24, num_tasks=5, num_layers=2, block="res+",
        aggr="softmax", learn_t=True, norm="batch", mlp_layers=1, dropout=0.0))
    model.load_state_dict(sd)
    model.train()
    x = g.x.clone().requires_grad_(True)
    n = z["co"].shape[0]
    # the reference arxiv model ends in log_softmax; the port emits logits
    out = torch.log_softmax(model(x, g)[:n], dim=-1)
    (out * torch.from_numpy(z["co"])).sum().backward()
    tol = dict(rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), z["out"], err_msg="out", **tol)
    np.testing.assert_allclose(x.grad[:n].numpy(), z["gx"], err_msg="gx", **tol)
    named = dict(model.named_parameters())
    assert set(named) == set(gd)
    for k, want in gd.items():
        np.testing.assert_allclose(named[k].grad.numpy(), want, err_msg=k, **tol)


def test_unported_options_raise():
    """The graph-level options are ported (held against JAX in
    `tests/test_torch_ogbg.py`) and build; values outside them, or the
    bond and atom encoders without their feature dimensions, or the virtual
    node outside res+, are refused."""
    base = dict(in_channels=4, hidden_channels=8, num_tasks=2, num_layers=2)
    dims = dict(atom_feature_dims=(3, 4), bond_feature_dims=(5, 6))
    for opt in (dict(edge_mode="bond"), dict(edge_mode="one_time_bond"),
                dict(add_virtual_node=True), dict(graph_pooling="mean"),
                dict(node_encoder="atom")):
        DeeperGCN(DeeperGCNConfig(**base, **opt, **dims))
    for opt in (dict(edge_mode="bogus"), dict(node_encoder="bogus"),
                dict(graph_pooling="median"), dict(add_virtual_node=True, block="res"),
                dict(node_encoder="atom"), dict(edge_mode="one_time_bond")):
        with pytest.raises(ValueError):
            DeeperGCN(DeeperGCNConfig(**base, **opt))
    with pytest.raises(NotImplementedError):
        DeeperGCN(DeeperGCNConfig(**base, block="dense"))


def test_bf16_deeper_gcn_forward_matches_jax(monkeypatch):
    """ResGEN with bf16 compute, 4 layers at C=128, against the JAX model on a
    band-attached graph (both sides take the band route; the JAX package's
    CPU gather route in bf16 is an unfused algorithm with other roundings).
    With the float32-accumulated Linear the logits agree to bf16 rounding
    noise: XLA's division flips about 0.4 % of the aggregated values by one
    bf16 ulp, and BatchNorm carries those flips on. The old bf16-rounded
    product added an error of its own to every Linear output."""
    import deep_gcns_torch_tpu.ops.band as jband
    import torch.nn.functional as F
    from deep_gcns_torch_tpu.graph import attach_band as jax_attach_band
    from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
    from deep_gcns_torch_tpu_torch.graph import attach_band
    from deep_gcns_torch_tpu_torch.nn.core import Linear

    monkeypatch.setattr(jband, "_TEST_MODE", True)
    rng = np.random.default_rng(0)
    n = 512
    s = rng.integers(0, n, n * 6)
    r = np.clip(s + rng.integers(-60, 61, n * 6), 0, n - 1)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    gj = jax_attach_band(jax_build_graph(x, s, r, num_nodes=n), window=256)
    gt = attach_band(build_graph(x, s, r, num_nodes=n), window=256)
    kw = dict(in_channels=16, hidden_channels=128, num_tasks=7, num_layers=4, block="res+",
              aggr="softmax_sg", t=0.1, norm="batch", mlp_layers=1, dropout=0.0,
              compute_dtype="bfloat16")
    jcfg = JaxConfig(**kw)
    jmodel = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    want = np.asarray(jmodel.apply(params, state, jnp.asarray(gj.x), gj, train=True)[0])[:n]
    model = DeeperGCN(DeeperGCNConfig(**kw))
    model.load_state_dict(deeper_gcn_state_dict_from_jax(_np_tree(params), _np_tree(state),
                                                         jcfg))
    model.train()
    err = np.abs(model(gt.x, gt).detach().numpy()[:n] - want)
    assert err.max() < 1e-2 and err.mean() < 1.2e-3, (err.max(), err.mean())

    def old_forward(self, x_, compute_dtype=None):
        y = F.linear(x_.to(compute_dtype), self.weight.to(compute_dtype)).float()
        return y + self.bias

    monkeypatch.setattr(Linear, "forward", old_forward)
    old = np.abs(model(gt.x, gt).detach().numpy()[:n] - want)
    assert old.mean() > 1.5e-3, old.mean()


def test_bf16_mean_deeper_gcn_matches_jax_kernel_route(monkeypatch):
    """ResGEN with `aggr="mean"` and bf16 compute, 4 layers at C=128, on a
    graph without a band: the port takes K1's route (the plain form's sum of
    the bf16 messages in float32, rounded once, over the clamped bf16
    degree), and the JAX model is run on its TPU kernel route, whose
    `segment_sum_csr` (the forward's sum and `gather_src`'s backward) runs
    in interpret mode here. The logits agree within the tolerance of
    `test_bf16_deeper_gcn_forward_matches_jax`, and the route is checked to
    run (every layer one CSR sum)."""
    import deep_gcns_torch_tpu.ops.gather as jgather
    import deep_gcns_torch_tpu.ops.segment as jseg
    import deep_gcns_torch_tpu.ops.spmm_pallas as jsp
    from deep_gcns_torch_tpu_torch.ops import segment as tseg

    seg_sum = jsp.segment_sum_csr

    def interpreted(m, r, p, interpret=False):
        return seg_sum(m, r, p, True)

    monkeypatch.setattr(jseg, "_pallas_ok", lambda aggr, row_ptr, msgs, n: (
        aggr in ("add", "sum", "mean") and row_ptr is not None))
    monkeypatch.setattr(jsp, "segment_sum_csr", interpreted)
    monkeypatch.setattr(jgather, "segment_sum_csr", interpreted)
    kw = dict(in_channels=16, hidden_channels=128, num_tasks=7, num_layers=4, block="res+",
              aggr="mean", norm="batch", mlp_layers=1, dropout=0.0, compute_dtype="bfloat16")
    gj, _ = jax_random_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    gt, _ = random_node_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    jcfg = JaxConfig(**kw)
    jmodel = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    want = np.asarray(jmodel.apply(params, state, jnp.asarray(gj.x), gj, train=True)[0])[:300]

    calls = []
    seg_t = tseg.segment_sum_csr
    monkeypatch.setattr(tseg, "segment_sum_csr", lambda *a: calls.append(1) or seg_t(*a))
    model = DeeperGCN(DeeperGCNConfig(**kw))
    model.load_state_dict(deeper_gcn_state_dict_from_jax(_np_tree(params), _np_tree(state),
                                                         jcfg))
    model.train()
    err = np.abs(model(gt.x, gt).detach().numpy()[:300] - want)
    assert len(calls) == 4
    assert err.max() < 1e-2 and err.mean() < 1.2e-3, (err.max(), err.mean())
