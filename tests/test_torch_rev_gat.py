"""The port's RevGAT (blocks, model, per-layer arguments of the reversible
stack, weight carry) against the JAX package and the numpy golden of
tests/test_rev_gat.py. The dense route's cases are in
tests/test_torch_rev_gat_dense.py.

Tolerances: the block golden as tests/test_rev_gat.py (rtol 1e-4 /
atol 1e-5); the model's forward and every gradient, and the band route
against the CSC route, as tests/test_band_gat.py
(rtol 4e-3 / atol 4e-4): both sides run float32 through four layers and
differ in the order of their sums and in the route (JAX on the CPU takes
the segment softmax where the port takes K5/K6's plain versions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.ops.band as jband
from deep_gcns_torch_tpu.graph import attach_band as jax_attach_band
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.models.rev_gat import RevGAT as JaxRevGAT
from deep_gcns_torch_tpu.models.rev_gat import RevGATConfig as JaxRevGATConfig
from deep_gcns_torch_tpu.utils.import_torch import export_revgat
from deep_gcns_torch_tpu_torch.graph import add_self_loops, attach_band, build_graph
from deep_gcns_torch_tpu_torch.models import RevGAT, RevGATBlock, RevGATConfig
from deep_gcns_torch_tpu_torch.models.rev_gat import draw_drop_keys
from deep_gcns_torch_tpu_torch.rev import reversible_stack
from deep_gcns_torch_tpu_torch.utils.import_jax import rev_gat_state_dict_from_jax
from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy
from np_ref import scatter_softmax_ref
from torch_budget import budget  # noqa: F401

MODEL = dict(rtol=4e-3, atol=4e-4)


@pytest.fixture
def band_mode():
    jband._TEST_MODE = True
    yield
    jband._TEST_MODE = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_revgatblock_matches_numpy_golden():
    """tests/test_rev_gat.py's block golden: batch-stats norm → relu →
    SymGATConv (sym-norm, sender-only scores, residual) in numpy from the
    reference equations."""
    rng = np.random.default_rng(0)
    n_valid, e, c = 60, 300, 12
    x = rng.standard_normal((n_valid, c)).astype(np.float32)
    s, r = add_self_loops(rng.integers(0, n_valid, e), rng.integers(0, n_valid, e), n_valid)
    g = build_graph(x, s, r, num_nodes=n_valid)
    blk = RevGATBlock(c, 6, n_heads=2, use_attn_dst=False, use_symmetric_norm=True,
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        blk.norm.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(4))
        blk.norm.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(5))
    blk.eval()
    y = blk(g.x, g).detach().numpy()

    n = g.num_nodes_padded
    xv, nm, em = g.x.numpy(), g.node_mask.numpy(), g.edge_mask.numpy()
    s_np, r_np = g.senders.numpy(), g.receivers.numpy()
    m = nm[:, None].astype(np.float32)
    cnt = max(m.sum(), 1.0)
    mu = (xv * m).sum(0) / cnt
    var = (np.square(xv - mu) * m).sum(0) / cnt
    h = (xv - mu) / np.sqrt(var + 1e-5)
    h = np.maximum(h * blk.norm.weight.detach().numpy() + blk.norm.bias.detach().numpy(), 0)
    conv = blk.conv
    feat = (h @ conv.fc.weight.detach().numpy().T).reshape(n, 2, 6)
    out_deg = np.bincount(s_np[em], minlength=n).astype(np.float32)
    feat_src = feat * np.power(np.maximum(out_deg, 1.0), -0.5)[:, None, None]
    el = (feat_src * conv.attn_l.detach().numpy()[0]).sum(-1)
    sc = el[np.minimum(s_np, n - 1)]
    sc = np.where(sc > 0, sc, 0.2 * sc)
    w = np.zeros_like(sc)
    w[em] = scatter_softmax_ref(sc[em], r_np[em], n)
    agg = np.zeros((n, 2, 6), np.float32)
    np.add.at(agg, r_np[em], feat_src[s_np[em]] * w[em][:, :, None])
    in_deg = np.bincount(r_np[em], minlength=n).astype(np.float32)
    agg = agg * np.power(np.maximum(in_deg, 1.0), 0.5)[:, None, None]
    agg = agg + (h @ conv.res_fc.weight.detach().numpy().T).reshape(n, 2, 6)
    np.testing.assert_allclose(y[:n_valid], agg.reshape(n, 12)[:n_valid], rtol=1e-4,
                               atol=1e-5)


def _graphs(rng, n=512, deg=6):
    """tests/test_band_gat.py's hub-heavy graph, with its band on both sides."""
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.9
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-100, 101, n * deg), 0, n - 1)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    gt = attach_band(build_graph(x, s, r, num_nodes=n), window=256, hubs=64)
    gj = jax_attach_band(jax_build_graph(x, s, r, num_nodes=n), window=256, hubs=64)
    return gt, gj


def _cfg(edge_drop):
    return dict(in_feats=32, n_classes=8, n_layers=4, n_hidden=12, n_heads=2, group=2,
                dropout=0.0, input_drop=0.0, edge_drop=edge_drop)


def _jax_drop_keys(rng_key, n_layers):
    """The keys JAX's RevGAT draws from ``rng_key`` (`models/rev_gat.py:165-171`)."""
    def key(i):
        return jax.random.fold_in(rng_key, i)
    mid = jax.vmap(lambda i: jband.drop_key_bits(jax.random.fold_in(key(2), i)))(
        jnp.arange(n_layers - 2))
    return (np.asarray(jband.drop_key_bits(key(1))), np.asarray(mid),
            np.asarray(jband.drop_key_bits(key(3))))


@pytest.mark.parametrize("route", ["csc", "band"])
@pytest.mark.parametrize("drop", [False, True])
def test_revgat_matches_jax(band_mode, route, drop):
    """RevGAT's loss, logits and every gradient against JAX with dropout 0
    and, with ``drop``, edge-drop from JAX's own keys: the port's CSC route
    against JAX's CPU route (the segment softmax), the band routes against
    each other."""
    _check_revgat_against_jax(route, drop)


def _check_revgat_against_jax(route, drop, **extra):
    rng = np.random.default_rng(1)
    gt, gj = _graphs(rng)
    if route == "csc":
        gt, gj = gt.replace(band=None), gj.replace(band=None)
    kw = dict(_cfg(0.4 if drop else 0.0), **extra)
    jcfg = JaxRevGATConfig(**kw)
    jmodel = JaxRevGAT(jcfg)
    params, _ = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    lab = rng.integers(0, 8, gt.num_nodes_padded)
    x = gt.x.numpy()
    rkey = jax.random.PRNGKey(7)

    def loss_j(p):
        out, _ = jmodel.apply(p, {}, jnp.asarray(x), gj, train=True, rng=rkey)
        logp = jax.nn.log_softmax(out, -1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(lab)[:, None], 1)[:, 0]
        m = gj.node_mask.astype(nll.dtype)
        return jnp.sum(nll * m) / jnp.sum(m), out

    (l_want, want), gp = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    model = RevGAT(RevGATConfig(**kw))
    model.load_state_dict(rev_gat_state_dict_from_jax(_jax_tree(params), jcfg))
    model.train()
    out = model(gt.x, gt, drop_keys=_jax_drop_keys(rkey, 4) if drop else None)
    loss = cross_entropy(out, _t(lab), gt.node_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_want), rtol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **MODEL)
    want_g = rev_gat_state_dict_from_jax(_jax_tree(gp), jcfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, **MODEL)


def test_revgat_band_matches_csc():
    """The port alone: edge-drop training through the band (K3/K1's plain
    versions with the hash plane) and through the CSC route (K5/K6's) give
    the same loss and gradients (tests/test_band_gat.py:101-131)."""
    rng = np.random.default_rng(2)
    gt, _ = _graphs(rng)
    model = RevGAT(RevGATConfig(**_cfg(0.4)), generator=torch.Generator().manual_seed(0))
    model.train()
    lab = _t(rng.integers(0, 8, gt.num_nodes_padded))
    keys = draw_drop_keys(torch.Generator().manual_seed(3), 4)
    res = []
    for g in (gt, gt.replace(band=None)):
        model.zero_grad(set_to_none=True)
        loss = cross_entropy(model(g.x, g, drop_keys=keys), lab, g.node_mask)
        loss.backward()
        res.append((float(loss.detach()),
                    {k: p.grad.clone() for k, p in model.named_parameters()}))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=2e-5)
    for k in res[0][1]:
        np.testing.assert_allclose(res[0][1][k].numpy(), res[1][1][k].numpy(), err_msg=k,
                                   **MODEL)


def test_revgat_eval_matches_jax_and_train_draws_from_the_generator():
    """Eval mode (no dropout, no edge-drop) against JAX's train=False; in
    training the same generator seed gives the same logits and another seed
    other logits (dropout masks and drop keys all come from it)."""
    rng = np.random.default_rng(4)
    gt, gj = _graphs(rng, n=256)
    gt, gj = gt.replace(band=None), gj.replace(band=None)
    kw = dict(_cfg(0.3), dropout=0.5, input_drop=0.2)
    jcfg = JaxRevGATConfig(**kw)
    params, _ = jax.jit(JaxRevGAT(jcfg).init)(jax.random.PRNGKey(1))
    want, _ = jax.jit(lambda p: JaxRevGAT(jcfg).apply(p, {}, jnp.asarray(gt.x.numpy()), gj,
                                                      train=False))(params)
    model = RevGAT(RevGATConfig(**kw))
    model.load_state_dict(rev_gat_state_dict_from_jax(_jax_tree(params), jcfg))
    model.eval()
    np.testing.assert_allclose(model(gt.x, gt).detach().numpy(), np.asarray(want), **MODEL)
    model.train()
    a = model(gt.x, gt, torch.Generator().manual_seed(5))
    b = model(gt.x, gt, torch.Generator().manual_seed(5))
    c = model(gt.x, gt, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    with pytest.raises(ValueError, match="generator or drop_keys"):
        model(gt.x, gt)
    first, mid, last = draw_drop_keys(torch.Generator().manual_seed(0), 5)
    assert len(mid) == 3 and all(-2 ** 31 <= k < 2 ** 31 for k in (*first, *last, *mid[0]))


def test_reversible_stack_layer_args_match_autograd():
    """Per-layer arguments (RevGAT's drop keys, one pair per layer) through
    the O(1)-memory engine against plain autograd through the same
    couplings: output, input gradient, every parameter and the shared
    dropout mask's absence of a gradient."""
    rng = np.random.default_rng(5)
    gt, _ = _graphs(rng, n=256)
    gt = gt.replace(band=None)
    model = RevGAT(RevGATConfig(**dict(_cfg(0.4), n_layers=5)),
                   generator=torch.Generator().manual_seed(1))
    model.train()
    layers = model.convs[1:-1]
    x0 = _t(rng.standard_normal((gt.num_nodes_padded, 24)).astype(np.float32))
    mask = (torch.rand(x0.shape, generator=torch.Generator().manual_seed(2)) > 0.2).float()
    layer_args = [(torch.tensor([[k0, k0], [k1, k1]], dtype=torch.int32),)
                  for k0, k1 in ((11, -5), (-2 ** 31, 2 ** 31 - 1), (0, 7))]

    def run(rev):
        layers.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(True)
        if rev:
            out = reversible_stack(layers, x, gt, (mask,), layer_args)
        else:
            out = x
            for layer, own in zip(layers, layer_args):
                out = layer(out, gt, mask, *own)
        (out ** 2).sum().backward()
        return [out.detach(), x.grad] + [p.grad.clone() for p in layers.parameters()]

    got, want = run(True), run(False)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError):
        reversible_stack(layers, x0, gt, (mask,), layer_args[:2])


@pytest.mark.parametrize("kw", [dict(), dict(use_attn_dst=True, n_layers=5, group=3,
                                             n_hidden=6)])
def test_weight_carry_covers_every_entry(kw):
    """rev_gat_state_dict_from_jax gives exactly the port's `state_dict`
    keys and shapes, and they are `export_revgat`'s reference names without
    `_fn.` and the BatchNorm running statistics."""
    base = dict(_cfg(0.3), **kw)
    jcfg = JaxRevGATConfig(**base)
    params, _ = jax.jit(JaxRevGAT(jcfg).init)(jax.random.PRNGKey(0))
    sd = rev_gat_state_dict_from_jax(_jax_tree(params), jcfg)
    model = RevGAT(RevGATConfig(**base))
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in own)
    ref = export_revgat(_jax_tree(params), jcfg)
    stats = (".running_mean", ".running_var", ".num_batches_tracked")
    want = {k.replace("._fn.", ".") for k in ref if not k.endswith(stats)}
    assert set(own) == want
    for k in own:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k.replace(".Fms.", "._fn.Fms.")])
    model.load_state_dict(sd)
