"""The link-level pieces of the port against the JAX package: the
LinkPredictor (with and without norms) and its weight carry, the ogbl-collab
loss through a DeeperGCN encoder and the predictor (every gradient), and
the apps' "adamw" optimizer against `adamw_warmup(lr, 0, wd)`, including a
resume from its `state_dict`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_gcns_torch_tpu.data.synthetic import sbm_arxiv_like as jax_sbm
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu.models.link_predictor import LinkPredictor as JaxLinkPredictor
from deep_gcns_torch_tpu.utils import optim as joptim
from deep_gcns_torch_tpu_torch.data.synthetic import sbm_arxiv_like
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig, LinkPredictor
from deep_gcns_torch_tpu_torch.utils.import_jax import (deeper_gcn_state_dict_from_jax,
                                                        link_predictor_state_dict_from_jax)
from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

# float32 on both sides; the difference is summation order
TOL = dict(rtol=1e-5, atol=1e-5)
# through 3 layers of aggregation and BatchNorm
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("norm", ["none", "batch", "layer"])
def test_link_predictor_matches_jax(norm):
    """sigmoid(MLP(x_i ⊙ x_j)) in training mode: scores, input gradients and
    every parameter's gradient, with `lins.{i}` / `norms.{i}` carried by
    `link_predictor_state_dict_from_jax`."""
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((50, 12)).astype(np.float32)
    xj = rng.standard_normal((50, 12)).astype(np.float32)
    co = rng.standard_normal((50, 1)).astype(np.float32)
    jm = JaxLinkPredictor(12, 16, 1, 3, norm, 0.0)
    params, state = jm.init(jax.random.PRNGKey(0))

    def f(p, a, b):
        y, _ = jm.apply(p, state, a, b, train=True)
        return jnp.sum(y * co), y

    (_, want), (gp, ga, gb) = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        params, jnp.asarray(xi), jnp.asarray(xj))
    lp = LinkPredictor(12, 16, 1, 3, norm, 0.0)
    sd = link_predictor_state_dict_from_jax(_np(params), _np(state))
    assert set(sd) == set(lp.state_dict())
    lp.load_state_dict(sd)
    lp.train()
    a, b = _t(xi).requires_grad_(True), _t(xj).requires_grad_(True)
    got = lp(a, b)
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), **TOL)
    want_g = link_predictor_state_dict_from_jax(_np(gp), _np(state))
    for k, p in lp.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, **TOL)


def test_collab_loss_matches_jax():
    """The ogbl-collab objective: a 3-layer DeeperGCN encoder (num_tasks =
    C) on the app's SBM and the predictor on gathered embeddings of
    positive and random negative edges, the pos/neg log loss; the loss and
    every gradient of both models against `jax.value_and_grad`."""
    n, c = 300, 16
    gj, _ = jax_sbm(np.random.default_rng(0), n=n, num_classes=8, c=64, avg_degree=8)
    gt, _ = sbm_arxiv_like(np.random.default_rng(0), n=n, num_classes=8, c=64, avg_degree=8)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, n, (2, 64))
    neg = rng.integers(0, n, (2, 64))
    kw = dict(in_channels=64, hidden_channels=c, num_tasks=c, num_layers=3, block="res+",
              aggr="softmax", t=1.0, norm="batch", mlp_layers=1, dropout=0.0)
    jcfg = JaxConfig(**kw)
    enc = JaxDeeperGCN(jcfg)
    pe, se = enc.init(jax.random.PRNGKey(0))
    jlp = JaxLinkPredictor(c, c, 1, 3, "none", 0.0)
    pl, sl = jlp.init(jax.random.PRNGKey(1))

    def loss_j(ap):
        h, _ = enc.apply(ap["enc"], se, gj.x, gj, train=True)
        p, _ = jlp.apply(ap["lp"], sl, h[pos[0]], h[pos[1]], train=True)
        q, _ = jlp.apply(ap["lp"], sl, h[neg[0]], h[neg[1]], train=True)
        return -jnp.log(p + 1e-15).mean() - jnp.log(1 - q + 1e-15).mean()

    want, gp = jax.value_and_grad(loss_j)({"enc": pe, "lp": pl})
    model = DeeperGCN(DeeperGCNConfig(**kw))
    model.load_state_dict(deeper_gcn_state_dict_from_jax(_np(pe), _np(se), jcfg))
    lp = LinkPredictor(c, c, 1, 3, "none", 0.0)
    lp.load_state_dict(link_predictor_state_dict_from_jax(_np(pl), _np(sl)))
    model.train()
    lp.train()
    h = model(gt.x, gt)
    p = lp(h[torch.from_numpy(pos[0])], h[torch.from_numpy(pos[1])])
    q = lp(h[torch.from_numpy(neg[0])], h[torch.from_numpy(neg[1])])
    loss = -torch.log(p + 1e-15).mean() - torch.log(1 - q + 1e-15).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **MODEL_TOL)
    g_enc = deeper_gcn_state_dict_from_jax(_np(gp["enc"]), _np(se), jcfg)
    for k, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), g_enc[k].numpy(), err_msg=k, **MODEL_TOL)
    g_lp = link_predictor_state_dict_from_jax(_np(gp["lp"]), _np(sl))
    for k, prm in lp.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), g_lp[k].numpy(), err_msg=k, **MODEL_TOL)


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_optimizer_matches_jax(wd):
    """`make_optimizer("adamw")` over 6 updates against the JAX apps'
    `adamw_warmup(lr, warmup_steps=0, weight_decay)`: the first update at
    lr 0 (moments only), the rest at lr; then resumed from its
    `state_dict` after 3 updates, the same 6 updates."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(6, 4)).astype(np.float32)
    grads = [rng.normal(size=(6, 4)).astype(np.float32) for _ in range(6)]
    tx = joptim.adamw_warmup(1e-2, warmup_steps=0, weight_decay=wd)
    pj, st = jnp.asarray(p0), None
    st = tx.init(pj)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)

    def run(resume_at=None):
        p = torch.nn.Parameter(torch.tensor(p0))
        opt = make_optimizer("adamw", [p], 1e-2, wd)
        for k, g in enumerate(grads):
            if k == 1:
                np.testing.assert_array_equal(p.detach().numpy(), p0)  # the lr-0 update
            if k == resume_at:
                sd = opt.state_dict()
                opt = make_optimizer("adamw", [p], 1e-2, wd)
                opt.load_state_dict(sd)
            p.grad = torch.tensor(g)
            opt.step()
        return p.detach().numpy()

    np.testing.assert_allclose(run(), np.asarray(pj), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(run(resume_at=3), run())
