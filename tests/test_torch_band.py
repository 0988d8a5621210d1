"""The port's band route against the JAX package's, on the CPU: K3's plain
version against the Pallas kernel in interpret mode, `band_spmm`,
`band_softmax_agg`, `band_sum_auto`, GENConv and a 4-layer DeeperGCN on a
band-attached graph (the JAX convs under `ops.band._TEST_MODE`, as
tests/test_band_convs.py runs them). The CUDA kernel against the plain
version is in test_torch_cuda.py.

Tolerances are those of tests/test_band.py (forward rtol 3e-4 / atol 1e-4,
softmax gradients rtol 3e-3) and tests/test_band_convs.py (2e-4): both sides
run in float32 and differ in the order of their sums. bf16 outputs agree to
one bf16 ulp of the final rounding (2⁻⁷ relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.ops.band as jband
from deep_gcns_torch_tpu.convs.sparse import GENConv as JaxGENConv
from deep_gcns_torch_tpu.graph import attach_band as jax_attach_band
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
import deep_gcns_torch_tpu_torch.convs.sparse as tconvs
import deep_gcns_torch_tpu_torch.ops.band as tband
from deep_gcns_torch_tpu_torch.convs.sparse import GENConv
from deep_gcns_torch_tpu_torch.graph import attach_band, build_graph
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig
from deep_gcns_torch_tpu_torch.utils.import_jax import deeper_gcn_state_dict_from_jax
from torch_budget import budget  # noqa: F401

BN = 128
FWD = dict(rtol=3e-4, atol=1e-4)
SOFT_GRAD = dict(rtol=3e-3, atol=1e-4)
CONV = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def band_mode():
    jband._TEST_MODE = True
    yield
    jband._TEST_MODE = False


def _t(a):
    return torch.from_numpy(np.array(a))


def banded_graph(rng, n, deg, bandwidth):
    s = rng.integers(0, n, n * deg)
    r = np.clip(s + rng.integers(-bandwidth, bandwidth + 1, n * deg), 0, n - 1)
    return s, r


def powerlaw_graph(rng, n, deg, alpha=0.9, bandwidth=200):
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** alpha
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-bandwidth, bandwidth + 1, n * deg), 0, n - 1)
    cross = rng.random(n * deg) < 0.3
    r[cross] = rng.integers(0, n, int(cross.sum()))
    return s, r


def _pairs(rng, kind="powerlaw", n=8 * BN, window=256, hubs=64):
    """The same band on both sides: hub columns, hub rows and a leftover in
    both directions."""
    s, r = powerlaw_graph(rng, n, 6) if kind == "powerlaw" else banded_graph(rng, n, 6, 800)
    jp = jband.build_band_pair(s, r, n, window, hubs)
    tp = tband.build_band_pair(s, r, n, window, hubs)
    assert tp.fwd.n_lo > 0 and tp.bwd.n_lo > 0
    return s, r, jp, tp


def _drops(with_drop):
    if not with_drop:
        return None, None
    thresh = jband.drop_thresh(0.3)
    return (jband.DropSpec(k0=jnp.int32(-123456789), k1=jnp.int32(987654), thresh=thresh),
            tband.DropSpec(k0=-123456789, k1=987654, thresh=thresh))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop,swap", [(False, False), (True, False), (True, True)])
def test_band_call_plain_matches_pallas_interpret(dtype, drop, swap):
    rng = np.random.default_rng(0)
    n = 4 * BN
    s, r, jp, tp = _pairs(rng, "banded", n=n, window=256, hubs=None)
    x = rng.standard_normal((n, 256)).astype(np.float32)
    jd, td = _drops(drop)
    band_j = jp.bwd if swap else jp.fwd
    band_t = tp.bwd if swap else tp.fwd
    want = jband._band_call(jnp.asarray(x).astype(dtype), band_j, True, jd, swap)
    got = tband.band_call_plain(_t(x).to(getattr(torch, dtype)), band_t, td, swap)
    assert got.dtype == getattr(torch, dtype)
    tol = FWD if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    if drop:  # the drop plane really removed edges
        full = tband.band_call_plain(_t(x), band_t)
        assert not torch.allclose(full, tband.band_call_plain(_t(x), band_t, td, swap))


@pytest.mark.parametrize("drop", [False, True])
def test_band_spmm_forward_and_grad(drop):
    rng = np.random.default_rng(1)
    s, r, jp, tp = _pairs(rng)
    n = 8 * BN
    x = rng.standard_normal((n, 128)).astype(np.float32)
    co = rng.standard_normal((n, 128)).astype(np.float32)
    jd, td = _drops(drop)

    def f(x_):
        out = jband.band_spmm(x_, jp, True, jd)
        return jnp.sum(out * co), out

    (_, want), gx = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = tband.band_spmm(xt, tp, td)
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **FWD)


@pytest.mark.parametrize("grad_weights", [False, True])
@pytest.mark.parametrize("kind", ["powerlaw", "banded"])
def test_band_softmax_agg_out_dx_dt(grad_weights, kind):
    rng = np.random.default_rng(2)
    s, r, jp, tp = _pairs(rng, kind)
    n = 8 * BN
    x = rng.standard_normal((n, 128)).astype(np.float32)
    co = rng.standard_normal((n, 128)).astype(np.float32)

    def f(x_, t_):
        out = jband.band_softmax_agg(x_, jp, t_, 1e-7, grad_weights, True)
        return jnp.sum(out * co), out

    (_, want), (gx, gt) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jnp.asarray([0.7], jnp.float32))
    xt = _t(x).requires_grad_(True)
    tt = torch.tensor([0.7], requires_grad=grad_weights)
    got = tband.band_softmax_agg(xt, tp, tt, 1e-7, grad_weights)
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **SOFT_GRAD)
    if grad_weights:
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), **SOFT_GRAD)
    else:
        assert float(np.asarray(gt)[0]) == 0.0 and tt.grad is None


def test_band_softmax_agg_bf16_matches_jax():
    rng = np.random.default_rng(3)
    s, r, jp, tp = _pairs(rng)
    x = rng.standard_normal((8 * BN, 128)).astype(np.float32)
    want = jband.band_softmax_agg(jnp.asarray(x).astype(jnp.bfloat16), jp,
                                  jnp.asarray([0.1], jnp.float32), 1e-7, False, True)
    got = tband.band_softmax_agg(_t(x).bfloat16(), tp, torch.tensor([0.1]))
    assert got.dtype == torch.bfloat16
    # the packed table, each structure's sum and each `+` round to bf16; one
    # ulp of a partial sum can pass to the quotient
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0 ** -6, atol=1e-3)


@pytest.mark.parametrize("c", [40, 128])
def test_band_sum_auto_matches_jax(c):
    """C=40 is padded to 128 lanes on the JAX side; the port pads nothing."""
    rng = np.random.default_rng(4)
    s, r, jp, tp = _pairs(rng)
    x = rng.standard_normal((8 * BN, c)).astype(np.float32)
    want = jband.band_sum_auto(jnp.asarray(x), jp, True)
    got = tband.band_sum_auto(_t(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def messy_graph(rng, n, deg, bandwidth):
    """Banded edges, explicit self loops and duplicated edges."""
    s = rng.integers(0, n, n * deg)
    r = np.clip(s + rng.integers(-bandwidth, bandwidth + 1, n * deg), 0, n - 1)
    loops = rng.integers(0, n, n // 4)
    dup = rng.integers(0, len(s), n // 4)
    return np.concatenate([s, loops, s[dup]]), np.concatenate([r, loops, r[dup]])


def _conv_state_dict(params, mlp_layers):
    """Port GENConv state_dict of a JAX GENConv (norm="layer")."""
    sd, seq = {}, 0
    for i in range(mlp_layers):
        lin = params["mlp"][i]["lin"]
        sd[f"mlp.{seq}.weight"] = _t(np.asarray(lin["w"]).T)
        sd[f"mlp.{seq}.bias"] = _t(lin["b"])
        seq += 1
        if i < mlp_layers - 1:
            sd[f"mlp.{seq}.weight"] = _t(params["mlp"][i]["norm"]["scale"])
            sd[f"mlp.{seq}.bias"] = _t(params["mlp"][i]["norm"]["bias"])
            seq += 2
    for k in ("t", "p", "y"):
        if k in params:
            sd[k] = _t(params[k])
    return sd


@pytest.mark.parametrize("aggr,learn_t,learn_p", [
    ("softmax_sg", False, False), ("softmax", True, False), ("mean", False, False),
    ("power", False, True)])
def test_genconv_band_route_matches_jax(band_mode, aggr, learn_t, learn_p):
    rng = np.random.default_rng(5)
    n = 512
    s, r = messy_graph(rng, n, 5, 220)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    gj = jax_attach_band(jax_build_graph(None, s, r, num_nodes=n), window=256)
    gt = attach_band(build_graph(None, s, r, num_nodes=n), window=256)
    assert 0.5 < gt.band.fwd.coverage < 1.0 and jband.band_ok(gj, aggr)
    kw = dict(aggr=aggr, t=0.5, learn_t=learn_t, learn_p=learn_p, norm="layer")
    jconv = JaxGENConv(in_dim=32, emb_dim=32, **kw)
    params, st = jax.jit(jconv.init)(jax.random.PRNGKey(0))
    conv = GENConv(32, 32, **kw)
    # a fixed t/p/y is a JAX param but a port buffer rebuilt from the config
    own = conv.state_dict()
    conv.load_state_dict({k: v for k, v in _conv_state_dict(params, 2).items() if k in own})

    def f(p, x_):
        out, _ = jconv.apply(p, st, x_, gj)
        return jnp.sum(jnp.cos(out)), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = conv(xt, gt)
    torch.cos(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CONV)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **CONV)
    want_g = _conv_state_dict(gp, 2)
    for k, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, **CONV)


@pytest.mark.parametrize("aggr,learn_t", [("softmax_sg", False), ("softmax", True)])
def test_deeper_gcn_band_matches_jax(band_mode, aggr, learn_t):
    """A 4-layer float32 DeeperGCN on a band graph with hubs and a leftover:
    logits and every gradient against the JAX model (dropout 0)."""
    rng = np.random.default_rng(6)
    n = 4 * BN
    s, r = powerlaw_graph(rng, n, 6)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    gj = jax_attach_band(jax_build_graph(x, s, r, num_nodes=n), window=256, hubs=64)
    gt = attach_band(build_graph(x, s, r, num_nodes=n), window=256, hubs=64)
    assert gt.band.fwd.hub_ids is not None and gt.band.fwd.n_lo > 0
    kw = dict(in_channels=16, hidden_channels=32, num_tasks=7, num_layers=4, block="res+",
              aggr=aggr, t=0.5, learn_t=learn_t, norm="batch", mlp_layers=1, dropout=0.0)
    jcfg, tcfg = JaxConfig(**kw), DeeperGCNConfig(**kw)
    co = rng.standard_normal((gt.num_nodes_padded, 7)).astype(np.float32)
    jmodel = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))

    def loss_j(p):
        logits, _ = jmodel.apply(p, state, jnp.asarray(gj.x), gj, train=True)
        return jnp.sum(logits * co), logits

    (_, logits_j), gp = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    model = DeeperGCN(tcfg)
    model.load_state_dict(deeper_gcn_state_dict_from_jax(np_tree(params), np_tree(state),
                                                         jcfg))
    model.train()
    logits = model(gt.x, gt)
    (logits * _t(co)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **tol)
    want = deeper_gcn_state_dict_from_jax(np_tree(gp), np_tree(state), jcfg)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), err_msg=k, **tol)


def test_genconv_takes_the_band_route(monkeypatch):
    """With a band attached the fused gather route is never called, and the
    band-attached and band-stripped graphs give the same output."""
    rng = np.random.default_rng(7)
    n = 512
    s, r = messy_graph(rng, n, 5, 60)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    g = attach_band(build_graph(x, s, r, num_nodes=n), window=512)
    conv = GENConv(32, 32, aggr="softmax_sg", t=0.3, norm="layer",
                   generator=torch.Generator().manual_seed(0))
    want = conv(g.x, g.replace(band=None))
    calls = {"band": 0}
    real = tconvs.band_softmax_agg_auto

    def counted(*a, **k):
        calls["band"] += 1
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the fused gather route ran on a band-attached graph")

    monkeypatch.setattr(tconvs, "band_softmax_agg_auto", counted)
    monkeypatch.setattr(tconvs, "fused_softmax_gather_agg_auto", refuse)
    got = conv(g.x, g)
    assert calls["band"] == 1
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **FWD)
