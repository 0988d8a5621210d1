"""The graph-level pieces of the port (activations, PReLU, the Atom/Bond
encoders, GENConv's bond encoder, DeeperGCN's atom encoder, bond edge modes,
virtual node and graph pooling, and the weight carry of them) against the
JAX package: the same numpy inputs and carried-across weights, outputs and
every gradient, float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.nn.core as jc
import deep_gcns_torch_tpu_torch.nn.core as tc
from deep_gcns_torch_tpu.convs.sparse import GENConv as JaxGENConv
from deep_gcns_torch_tpu.data.ogb_features import ATOM_FEATURE_DIMS as JAX_ATOM
from deep_gcns_torch_tpu.data.ogb_features import BOND_FEATURE_DIMS as JAX_BOND
from deep_gcns_torch_tpu.graph import batch_graphs as jax_batch_graphs
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu_torch.convs.sparse import GENConv
from deep_gcns_torch_tpu_torch.data.ogb_features import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
from deep_gcns_torch_tpu_torch.graph import batch_graphs
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig
from deep_gcns_torch_tpu_torch.utils.import_jax import deeper_gcn_state_dict_from_jax
from torch_budget import budget  # noqa: F401

# elementwise ops: float32 on both sides, the same operations
TOL = dict(rtol=1e-5, atol=1e-5)
# through 2-3 layers of aggregation, BatchNorm and pooling: summation order
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mols(rng, n_graphs=4, edge_float=0):
    """Small molecule-shaped graphs: 5-9 atoms with 3n bonds, integer atom
    and bond features (or ``edge_float`` float edge features and the 7
    scattered node features of ogbg-ppa)."""
    gs = []
    for _ in range(n_graphs):
        n = int(rng.integers(5, 10))
        e = 3 * n
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        if edge_float:
            ea = rng.random((e, edge_float)).astype(np.float32)
            x = np.zeros((n, edge_float), np.float32)
            np.add.at(x, r, ea)
        else:
            x = np.stack([rng.integers(0, d, n) for d in ATOM_FEATURE_DIMS], 1).astype(np.int32)
            ea = np.stack([rng.integers(0, d, e) for d in BOND_FEATURE_DIMS], 1).astype(np.int32)
        gs.append(dict(x=x, senders=s, receivers=r, edge_attr=ea))
    return gs


def _batches(gs):
    kw = dict(node_pad=64, edge_pad=256)
    return jax_batch_graphs(gs, **kw), batch_graphs(gs, **kw)


def test_feature_dims_match_jax():
    assert ATOM_FEATURE_DIMS == JAX_ATOM and BOND_FEATURE_DIMS == JAX_BOND


@pytest.mark.parametrize("act", ["relu", "leakyrelu", "prelu", None])
def test_activation_matches_jax(act):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 6)).astype(np.float32)
    co = rng.standard_normal((30, 6)).astype(np.float32)
    slope = tc.prelu_init(act)
    if act == "prelu":
        assert float(slope.detach()) == pytest.approx(0.2) and tc.prelu_init("relu") is None
    p_j = None if slope is None else jnp.asarray(slope.detach().numpy()) * 1.5

    def f(x_, p_):
        return jnp.sum(jc.activation(act, x_, prelu=p_) * co)

    if p_j is None:
        gx = jax.jit(jax.grad(f))(jnp.asarray(x), None)
        gp = None
    else:
        gx, gp = jax.jit(jax.grad(f, (0, 1)))(jnp.asarray(x), p_j)
    want = jc.activation(act, jnp.asarray(x), prelu=p_j)
    xt = _t(x).requires_grad_(True)
    pt = None if p_j is None else _t(p_j).requires_grad_(True)
    got = tc.activation(act, xt, prelu=pt)
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    if pt is not None:
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp), **TOL)
    with pytest.raises(NotImplementedError):
        tc.activation("gelu", xt)


def test_prelu_and_identity_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, 5)).astype(np.float32)
    co = rng.standard_normal((20, 5)).astype(np.float32)
    mod = tc.PReLU(0.3)
    assert set(mod.state_dict()) == {"weight"}
    pj, _ = jc.PReLU(0.3).init(jax.random.PRNGKey(0))

    def f(p):
        y, _ = jc.PReLU(0.3).apply(p, {}, jnp.asarray(x))
        return jnp.sum(y * co), y

    (_, want), gp = jax.jit(jax.value_and_grad(f, has_aux=True))(pj)
    got = mod(_t(x))
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(mod.weight.grad.numpy(), np.asarray(gp["a"]), **TOL)
    ident, _ = jc.Identity().apply({}, {}, jnp.asarray(x))
    np.testing.assert_array_equal(tc.Identity()(_t(x), None).numpy(), np.asarray(ident))


def test_embeddings_match_jax_with_reference_names():
    """Embedding and the Atom/Bond encoder pattern (a sum of per-column
    tables): forward and table gradients, the Xavier bound, the
    reference's `atom_embedding_list.{i}.weight` names."""
    rng = np.random.default_rng(2)
    enc = tc.MultiEmbedding(ATOM_FEATURE_DIMS, 16, "atom_embedding_list",
                            torch.Generator().manual_seed(0))
    assert set(enc.state_dict()) == {f"atom_embedding_list.{i}.weight"
                                     for i in range(len(ATOM_FEATURE_DIMS))}
    for d, emb in zip(ATOM_FEATURE_DIMS, enc.tables):
        assert float(emb.weight.detach().abs().max()) <= np.sqrt(6.0 / (d + 16))
    x = np.stack([rng.integers(0, d, 40) for d in ATOM_FEATURE_DIMS], 1).astype(np.int32)
    co = rng.standard_normal((40, 16)).astype(np.float32)
    p = {"tables": [jnp.asarray(e.weight.detach().numpy()) for e in enc.tables]}

    def f(p_):
        y, _ = jc.MultiEmbedding(ATOM_FEATURE_DIMS, 16).apply(p_, {}, jnp.asarray(x))
        return jnp.sum(y * co), y

    (_, want), gp = jax.jit(jax.value_and_grad(f, has_aux=True))(p)
    got = enc(torch.from_numpy(x))
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for e, g in zip(enc.tables, gp["tables"]):
        np.testing.assert_allclose(e.weight.grad.numpy(), np.asarray(g), **TOL)
    one = tc.Embedding(7, 3)
    want1, _ = jc.Embedding(7, 3).apply({"w": jnp.asarray(one.weight.detach().numpy())}, {},
                                        jnp.asarray(x[:, 2] % 7))
    np.testing.assert_array_equal(one(torch.from_numpy(x[:, 2] % 7)).detach().numpy(),
                                  np.asarray(want1))


def test_kaiming_reinit_and_init_all():
    """Linear weights re-drawn with std √(2/in) and biases zeroed, as the
    JAX rule does to `w`/`b` leaves; the Atom/Bond encoder's tables (JAX
    `tables`) and the norms stay as they are."""
    mods = tc.init_all([("lin", tc.Linear(50, 30)), ("enc", tc.MultiEmbedding((400, 7), 8)),
                        ("bn", tc.BatchNorm(30))])
    assert list(mods) == ["lin", "enc", "bn"]
    tables = [e.weight.detach().clone() for e in mods["enc"].tables]
    tc.kaiming_reinit(mods, torch.Generator().manual_seed(0))
    assert float(mods["lin"].bias.detach().abs().max()) == 0.0
    assert float(mods["lin"].weight.detach().std()) == pytest.approx(np.sqrt(2 / 50), rel=0.1)
    assert all(torch.equal(e.weight, t) for e, t in zip(mods["enc"].tables, tables))
    assert float(mods["bn"].weight.detach().min()) == 1.0
    p, _ = jc.init_all(jax.random.PRNGKey(0), [("lin", jc.Linear(50, 30)),
                                               ("enc", jc.MultiEmbedding((400, 7), 8))])
    q = jc.kaiming_reinit(p, jax.random.PRNGKey(1))
    assert float(jnp.abs(q["lin"]["b"]).max()) == 0.0
    assert all(bool((a == b).all()) for a, b in zip(p["enc"]["tables"], q["enc"]["tables"]))


def test_prelu_mlp_matches_jax():
    """An MLP with PReLU: the slope's name is its `nn.Sequential` index and
    its gradient matches JAX's `prelu` entry."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((24, 6)).astype(np.float32)
    co = rng.standard_normal((24, 4)).astype(np.float32)
    mlp = tc.MLP([6, 8, 4], norm=None, act="prelu", last_lin=True)
    assert set(mlp.state_dict()) == {"0.weight", "0.bias", "1.weight", "2.weight", "2.bias"}
    sd = {k: jnp.asarray(v.numpy()) for k, v in mlp.state_dict().items()}
    p = [{"lin": {"w": sd["0.weight"].T, "b": sd["0.bias"]}, "prelu": sd["1.weight"]},
         {"lin": {"w": sd["2.weight"].T, "b": sd["2.bias"]}}]
    mod = jc.MLP((6, 8, 4), act="prelu", last_lin=True)

    def f(p_):
        y, _ = mod.apply(p_, [{}, {}], jnp.asarray(x))
        return jnp.sum(y * co), y

    (_, want), gp = jax.jit(jax.value_and_grad(f, has_aux=True))(p)
    got = mlp(_t(x))
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(mlp[1].weight.grad.numpy(), np.asarray(gp[0]["prelu"]), **TOL)


@pytest.mark.parametrize("aggr,learn_t", [("softmax", True), ("softmax_sg", False),
                                          ("mean", False)])
def test_genconv_bond_encoder_matches_jax(aggr, learn_t):
    """GENConv with its own BondEncoder on a molecule batch: the port's fused
    route (K2 with `ee`, K4 with the CSC twin; plain versions here) and the
    mean route against JAX's CPU route. Every table's gradient comes from
    the sender-ordered lookup alone: counting the receiver-ordered one too
    would double it."""
    rng = np.random.default_rng(4)
    gj, gt = _batches(_mols(rng))
    c = 16
    conv_j = JaxGENConv(c, c, aggr=aggr, t=0.7, learn_t=learn_t, encode_edge=True,
                        bond_encoder=True, bond_feature_dims=JAX_BOND, norm="batch",
                        mlp_layers=1)
    params, state = jax.jit(conv_j.init)(jax.random.PRNGKey(1))
    x = rng.standard_normal((gt.num_nodes_padded, c)).astype(np.float32)
    co = rng.standard_normal((gt.num_nodes_padded, c)).astype(np.float32)

    def loss(p, x_):
        out, _ = conv_j.apply(p, state, x_, gj, train=True)
        return jnp.sum(out * co), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
        params, jnp.asarray(x))
    conv = GENConv(c, c, aggr=aggr, t=0.7, learn_t=learn_t, encode_edge=True,
                   bond_encoder=True, bond_feature_dims=BOND_FEATURE_DIMS, norm="batch",
                   mlp_layers=1)
    p = _np(params)
    sd = {"mlp.0.weight": _t(p["mlp"][0]["lin"]["w"].T), "mlp.0.bias": _t(p["mlp"][0]["lin"]["b"])}
    for k, tbl in enumerate(p["edge_encoder"]["tables"]):
        sd[f"edge_encoder.bond_embedding_list.{k}.weight"] = _t(tbl)
    if learn_t:
        sd["t"] = _t(p["t"])
    conv.load_state_dict(sd)
    conv.train()
    xt = _t(x).requires_grad_(True)
    out = conv(xt, gt)
    (out * _t(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **MODEL_TOL)
    for k, g in enumerate(gp["edge_encoder"]["tables"]):
        np.testing.assert_allclose(conv.edge_encoder.tables[k].weight.grad.numpy(),
                                   np.asarray(g), err_msg=f"table {k}", **MODEL_TOL)
    np.testing.assert_allclose(conv.mlp[0].weight.grad.numpy(),
                               np.asarray(gp["mlp"][0]["lin"]["w"]).T, **MODEL_TOL)
    if learn_t:
        np.testing.assert_allclose(conv.t.grad.numpy(), np.asarray(gp["t"]), **MODEL_TOL)


# (name, config fields, the molecule data's float edge width or 0 for integer)
MODEL_CASES = [
    ("mol-bond-vn-mean", dict(node_encoder="atom", edge_mode="bond", add_virtual_node=True,
                              graph_pooling="mean", aggr="softmax", learn_t=True), 0),
    ("mol-one_time_bond-sum", dict(node_encoder="atom", edge_mode="one_time_bond",
                                   graph_pooling="sum", aggr="softmax_sg"), 0),
    ("ppa-one_time-mean", dict(in_channels=7, edge_mode="one_time", edge_feat_dim=7,
                               graph_pooling="mean", aggr="softmax_sg", t=0.01), 7),
    ("mol-bond-vn-max", dict(node_encoder="atom", edge_mode="bond", add_virtual_node=True,
                             graph_pooling="max", aggr="softmax_sg"), 0),
]


@pytest.mark.parametrize("name,fields,edge_float", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_graph_level_deeper_gcn_matches_jax(name, fields, edge_float):
    """DeeperGCN at graph level (3 layers, C=16, 4 graphs a batch, padded
    nodes and edges): logits, the new BatchNorm statistics (the virtual
    node's MLPs' too) and every parameter's gradient, carried both ways by
    `deeper_gcn_state_dict_from_jax`."""
    kw = dict(in_channels=0, hidden_channels=16, num_tasks=3, num_layers=3, block="res+",
              t=0.7, norm="batch", mlp_layers=1, dropout=0.0, final_relu=False,
              atom_feature_dims=ATOM_FEATURE_DIMS, bond_feature_dims=BOND_FEATURE_DIMS)
    kw.update(fields)
    jcfg, tcfg = JaxConfig(**kw), DeeperGCNConfig(**kw)
    rng = np.random.default_rng(5)
    gj, gt = _batches(_mols(rng, edge_float=edge_float))
    co = rng.standard_normal((4, 3)).astype(np.float32)
    jmodel = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    if "vn_emb" in params:  # a non-zero virtual node exercises its gather
        params["vn_emb"] = jnp.asarray(rng.standard_normal((1, 16)).astype(np.float32))

    def loss_j(p):
        logits, ns = jmodel.apply(p, state, gj.x, gj, train=True)
        return jnp.sum(logits * co), (logits, ns)

    (_, (logits_j, ns_j)), gp_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    model = DeeperGCN(tcfg)
    sd = deeper_gcn_state_dict_from_jax(_np(params), _np(state), jcfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    model.train()
    logits = model(gt.x, gt)
    (logits * _t(co)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **MODEL_TOL)
    want_state = deeper_gcn_state_dict_from_jax(_np(params), _np(ns_j), jcfg)
    for k, buf in model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_state[k].numpy(), err_msg=k,
                                       **MODEL_TOL)
    want_grad = deeper_gcn_state_dict_from_jax(_np(gp_j), _np(ns_j), jcfg)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grad[k].numpy(), err_msg=k,
                                   **MODEL_TOL)


def test_graph_pooling_masks_padding():
    """Pooling divides by real node counts and ignores padded rows, whatever
    they hold: filling the padding moves the logits by rounding only (the
    fused aggregation's global shift is a max over all N_pad rows, padding
    included, as in the JAX package), where counting padded rows would move
    them by O(1)."""
    rng = np.random.default_rng(6)
    _, gt = _batches(_mols(rng))
    model = DeeperGCN(DeeperGCNConfig(
        in_channels=0, hidden_channels=8, num_tasks=2, num_layers=2, graph_pooling="mean",
        node_encoder="atom", atom_feature_dims=ATOM_FEATURE_DIMS, edge_mode="bond",
        bond_feature_dims=BOND_FEATURE_DIMS, add_virtual_node=True, final_relu=False),
        generator=torch.Generator().manual_seed(0))
    model.eval()
    base = model(gt.x, gt)
    x2 = gt.x.clone()
    x2[gt.n_node:] = 1  # a valid index of every atom feature
    np.testing.assert_allclose(model(x2, gt).detach().numpy(), base.detach().numpy(), **TOL)
    assert base.shape == (4, 2)
