"""The port's reversible engine and RevGCN against the JAX package
(`tests/test_rev.py`) and the reference golden `ref_rev_coupling.npz`.

Tolerances: the coupling's inverse and the reversible gradients follow
tests/test_rev.py (inverse rtol 1e-4 / atol 1e-5, gradients rtol 2e-3 /
atol 2e-4); the port against JAX runs float32 on both sides through a few
layers, so only the order of the sums differs (rtol/atol 1e-4)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.models.rev_gcn import RevGCN as JaxRevGCN
from deep_gcns_torch_tpu.models.rev_gcn import RevGCNConfig as JaxRevGCNConfig
from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.models import RevGCN, RevGCNConfig
from deep_gcns_torch_tpu_torch.nn.core import shared_dropout_mask
from deep_gcns_torch_tpu_torch.rev import GENBlock, GroupAdditiveCoupling, reversible_stack
from deep_gcns_torch_tpu_torch.rev.rev_layer import GATBlock, GCNBlock, SAGEBlock
from deep_gcns_torch_tpu_torch.utils.import_jax import rev_gcn_state_dict_from_jax

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=2e-3, atol=2e-4)


def _graph(seed, n=60, e=240, edge_dim=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    ea = rng.standard_normal((e, edge_dim)).astype(np.float32) if edge_dim else None
    return (build_graph(x, s, r, edge_attr=ea, num_nodes=n),
            jax_build_graph(x, s, r, edge_attr=ea, num_nodes=n))


def _coupling(hidden, group, edge_dim=0, seed=0):
    gen = torch.Generator().manual_seed(seed)
    cg = hidden // group
    return GroupAdditiveCoupling([
        GENBlock(cg, cg, aggr="softmax", learn_t=True, norm="layer", mlp_layers=1,
                 encode_edge=edge_dim > 0, edge_feat_dim=hidden if edge_dim else 0,
                 generator=gen)
        for _ in range(group)])


@pytest.mark.parametrize("group", [1, 2, 4])
def test_coupling_inverse_exact(group):
    g, _ = _graph(0)
    coupling = _coupling(16, group).train()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (g.num_nodes_padded, 16)).astype(np.float32))
    mask = shared_dropout_mask(x.shape, 0.3, torch.Generator().manual_seed(2))
    with torch.no_grad():
        y = coupling(x, g, mask)
        x_rec = coupling.inverse(y, g, mask)
    np.testing.assert_allclose(x_rec.numpy(), x.numpy(), rtol=1e-4, atol=1e-5)


def test_reversible_grads_match_autograd():
    """The O(1)-memory Function against plain autograd through the same five
    couplings: input, every parameter, the dropout mask's absence of a
    gradient and the edge embeddings' summed gradient in both orders."""
    g, _ = _graph(3, edge_dim=8)
    layers = torch.nn.ModuleList(_coupling(16, 2, edge_dim=8, seed=s) for s in range(5))
    layers.train()
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((g.num_nodes_padded, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32) * 0.3)
    mask = shared_dropout_mask(x0.shape, 0.1, torch.Generator().manual_seed(5))

    def run(rev):
        layers.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        ee, ee_csc = (g.edge_attr @ ww).repeat(1, 2), (g.edge_attr_csc @ ww).repeat(1, 2)
        if rev:
            out = reversible_stack(layers, x, g, (mask, ee, ee_csc))
        else:
            out = x
            for layer in layers:
                out = layer(out, g, mask, ee, ee_csc)
        (out ** 2).sum().backward()
        return out.detach(), x.grad, ww.grad, [p.grad.clone() for p in layers.parameters()]

    got, want = run(True), run(False)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1:3] + tuple(got[3]), want[1:3] + tuple(want[3])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_reversible_forward_keeps_no_graph():
    """The forward runs without grad: only the output holds a grad_fn, and it
    is the engine's Function, not a chain of layer operations."""
    g, _ = _graph(6)
    layers = torch.nn.ModuleList(_coupling(16, 2, seed=s) for s in range(3))
    x = torch.randn(g.num_nodes_padded, 16, requires_grad=True)
    out = reversible_stack(layers, x, g, (None,))
    assert type(out.grad_fn).__name__ == "_ReversibleStackBackward"
    # its inputs are leaves (x and the parameters): no layer operation is recorded
    nexts = [f for f, _ in out.grad_fn.next_functions if f is not None]
    assert len(nexts) == 1 + sum(1 for _ in layers.parameters())
    assert all(type(f).__name__ == "AccumulateGrad" for f in nexts)


def _jax_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("aggr,learn_t,one_hot", [("softmax", False, True),
                                                  ("softmax", True, True),
                                                  ("softmax_sg", False, False)])
def test_revgcn_matches_jax(aggr, learn_t, one_hot):
    kw = dict(in_channels=8, node_feat_dim=8, edge_feat_dim=8, hidden_channels=16,
              num_tasks=7, num_layers=4, group=2, aggr=aggr, t=0.7, learn_t=learn_t,
              dropout=0.0, use_one_hot_encoding=one_hot)
    gt, gj = _graph(7, n=80, e=400, edge_dim=8)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((gt.num_nodes_padded, 8)).astype(np.float32)
    nf = rng.standard_normal((gt.num_nodes_padded, 8)).astype(np.float32)
    co = rng.standard_normal((gt.num_nodes_padded, 7)).astype(np.float32)
    co[80:] = 0.0
    jcfg = JaxRevGCNConfig(**kw)
    jmodel = JaxRevGCN(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(0))

    def loss_j(p):
        out, _ = jmodel.apply(p, state, jnp.asarray(x), gj, node_feats=jnp.asarray(nf),
                              train=True, rng=jax.random.PRNGKey(1))
        return jnp.sum(out * co), out

    (_, want), gp = jax.value_and_grad(loss_j, has_aux=True)(params)

    model = RevGCN(RevGCNConfig(**kw))
    model.load_state_dict(rev_gcn_state_dict_from_jax(_jax_tree(params), jcfg))
    model.train()
    out = model(torch.from_numpy(x), gt, node_feats=torch.from_numpy(nf))
    (out * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    want_g = rev_gcn_state_dict_from_jax(_jax_tree(gp), jcfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    g_max = max(float(np.abs(v.numpy()).max()) for v in want_g.values())
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k,
                                   rtol=1e-3, atol=1e-5 * g_max)


def test_rev_coupling_reference_golden():
    """The engine against the reference's InvertibleCheckpointFunction: the
    golden's `inv._fn.Fms.{g}.*` weights load into the coupling after
    dropping the wrapper's `inv._fn.` prefix."""
    z = np.load(os.path.join(GOLD, "ref_rev_coupling.npz"))
    pre = "inv._fn."
    sd = {k[3 + len(pre):]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    gd = {k[3 + len(pre):]: z[k] for k in z.files if k.startswith("gd.")}
    ei = z["edge_index"]
    n = z["x"].shape[0]
    g = build_graph(z["x"], ei[0], ei[1], num_nodes=n)
    coupling = _coupling(32, 2)
    coupling.load_state_dict(sd)
    coupling.train()
    layers = torch.nn.ModuleList([coupling])
    x = torch.zeros(g.num_nodes_padded, 32)
    x[:n] = torch.from_numpy(z["x"])
    x.requires_grad_(True)
    out = reversible_stack(layers, x, g)
    (out[:n] * torch.from_numpy(z["co"])).sum().backward()
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out[:n].detach().numpy(), z["out"], err_msg="out", **tol)
    np.testing.assert_allclose(x.grad[:n].numpy(), z["gx"], err_msg="gx", **tol)
    named = dict(coupling.named_parameters())
    assert set(named) == set(gd)
    for k, want in gd.items():
        np.testing.assert_allclose(named[k].grad.numpy(), want, err_msg=k, **tol)


@pytest.mark.parametrize("kw", [dict(), dict(use_one_hot_encoding=False, learn_t=True,
                                             aggr="softmax", msg_norm=True),
                                dict(edge_feat_dim=0, group=4)])
def test_weight_carry_covers_every_entry(kw):
    """rev_gcn_state_dict_from_jax gives exactly the port's `state_dict`
    keys and shapes, so a strict `load_state_dict` takes it."""
    base = dict(hidden_channels=16, num_tasks=5, num_layers=3, group=2)
    base.update(kw)
    jcfg = JaxRevGCNConfig(**base)
    params, _ = JaxRevGCN(jcfg).init(jax.random.PRNGKey(0))
    sd = rev_gcn_state_dict_from_jax(_jax_tree(params), jcfg)
    model = RevGCN(RevGCNConfig(**base))
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in own)
    model.load_state_dict(sd)
    np.testing.assert_array_equal(model.gcns[2].Fms[1].gcn.mlp[0].weight.detach().numpy(),
                                  np.asarray(params["layers"]["gcn"]["mlp"][0]["lin"]["w"]
                                             )[2, 1].T)


def test_stateful_group_functions_are_refused():
    with pytest.raises(ValueError):
        GroupAdditiveCoupling([GENBlock(8, 8, norm="batch") for _ in range(2)])
    for block in (GCNBlock, SAGEBlock, GATBlock):
        with pytest.raises(NotImplementedError):
            block(8, 8)
    with pytest.raises(NotImplementedError):
        RevGCN(RevGCNConfig(conv="gat", num_layers=2))


def test_shared_dropout_mask():
    m = shared_dropout_mask((4000, 16), 0.25, torch.Generator().manual_seed(0))
    vals = set(np.unique(m.numpy()).tolist())
    assert vals == {0.0, np.float32(1 / 0.75)}
    assert abs(float((m > 0).float().mean()) - 0.75) < 0.01
    again = shared_dropout_mask((4000, 16), 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(m, again)
