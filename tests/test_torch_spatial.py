"""`SpatialDeeperGCN` and `spatial_train_step` on D ∈ {2, 3} gloo ranks
against the JAX package's spatial layer under `shard_map` on D of
conftest's virtual CPU devices, on the same numpy inputs and weights
(carried across by `utils.import_jax`).

Each D spawns its ranks once (a module fixture) and runs every case there:
the collectives' adjointness, forwards under the halo exchange, the
all-gather and the spatial × band route (softmax and sum families), the
res, plain and res+ blocks, edge features, and train steps with LayerNorm
and with BatchNorm on an uneven split (n=900 over 3 ranks: 512, 388 and 0
valid rows), whose equal-weight cross-rank moments are JAX's quirk
(ROADMAP §3), pinned here against JAX's spatial step. Tolerances are
tests/test_spatial.py's: forward rtol 2e-4 / atol 2e-5, updated parameters
after an SGD step rtol 3e-4 / atol 3e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_cases as tpc
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu.parallel.mesh import make_mesh
from deep_gcns_torch_tpu.parallel.spatial import SpatialDeeperGCN as JaxSpatial
from deep_gcns_torch_tpu.parallel.spatial import shard_graph as jax_shard_graph
from deep_gcns_torch_tpu.parallel.spatial import spatial_forward as jax_spatial_forward
from deep_gcns_torch_tpu.parallel.spatial import spatial_train_step as jax_spatial_step
from deep_gcns_torch_tpu_torch.parallel import launch, shard_graph, shard_nodes
from deep_gcns_torch_tpu_torch.utils.import_jax import deeper_gcn_state_dict_from_jax
import torch_budget
from torch_budget import budget  # noqa: F401

FWD = dict(rtol=2e-4, atol=2e-5)
STEP = dict(rtol=3e-4, atol=3e-5)
BASE = dict(hidden_channels=24, num_tasks=5, num_layers=3, block="res+", aggr="softmax",
            norm="layer", mlp_layers=1, dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graph(n, e, c, edge_dim=0, seed=0, local=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.clip(s + rng.integers(-80, 81, e), 0, n - 1) if local else rng.integers(0, n, e)
    x = rng.standard_normal((n, c)).astype(np.float32)
    ea = rng.standard_normal((e, edge_dim)).astype(np.float32) if edge_dim else None
    labels = rng.integers(0, BASE["num_tasks"], n)
    return s, r, x, ea, labels


def _nll(logits, lab, m):
    logp = jax.nn.log_softmax(logits, -1)
    nll = -jnp.take_along_axis(logp, lab[:, None], 1)[:, 0]
    m = m.astype(nll.dtype)
    return jnp.sum(nll * m), jnp.sum(m)


class Case:
    """One configuration: the JAX side's results now, the port's case dict
    for the ranks, and the comparison once the ranks are back."""

    def __init__(self, name, d, n=900, e=5000, c=16, edge_dim=0, exchange="halo",
                 band="off", step=False, seed=0, local=False, **cfg):
        self.name, self.d, self.n, self.step = name, d, n, step
        kw = dict(BASE, in_channels=c, **cfg)
        if edge_dim:
            kw.update(edge_mode="per_layer", edge_feat_dim=edge_dim)
        s, r, x, ea, labels = _graph(n, e, c, edge_dim, seed, local)
        jcfg = JaxConfig(**kw)
        model = JaxSpatial(jcfg, exchange=exchange, band_interpret=band != "off")
        params, state = jax.jit(model.init)(jax.random.PRNGKey(seed))
        params, state = _np(params), _np(state)
        jsh = jax_shard_graph(s, r, n, d, edge_attr=ea, band=band)
        sh = shard_graph(s, r, n, d, edge_attr=ea, band=band)
        xs = shard_nodes(x, sh)
        mesh = make_mesh(("gp",), devices=jax.devices()[:d])
        sd = {k: v.numpy() for k, v in
              deeper_gcn_state_dict_from_jax(params, state, jcfg).items()}
        self.port = dict(kind="deeper", cfg=kw, exchange=exchange, state=sd, shards=sh, x=xs)
        self.jcfg, self.params = jcfg, params
        if not step:
            out = jax_spatial_forward(model, mesh)(params, state, jnp.asarray(xs),
                                                   jax.device_put(jsh))
            self.want = np.asarray(out).reshape(-1, kw["num_tasks"])[:n]
            return
        lab = shard_nodes(labels[:, None].astype(np.int32), sh)[..., 0]
        mask = np.asarray(sh.node_mask) & (shard_nodes(
            (np.arange(n) % 3 != 0)[:, None], sh)[..., 0])
        self.port.update(lr=0.1, labels=lab, mask=mask)
        tx = optax.sgd(0.1)
        p2, s2, _, loss = jax_spatial_step(model, tx, _nll, mesh)(
            params, state, tx.init(params), jnp.asarray(xs), jax.device_put(jsh),
            jnp.asarray(lab), jnp.asarray(mask), jax.random.PRNGKey(3))
        self.want_loss = float(loss)
        self.want_state = {k: v.numpy() for k, v in deeper_gcn_state_dict_from_jax(
            _np(p2), _np(s2), jcfg).items()}

    def check(self, ranks):
        got = [rk["results"] for rk in ranks]
        if not self.step:
            out = np.concatenate([g[self.index]["logits"] for g in got])[:self.n]
            np.testing.assert_allclose(out, self.want, err_msg=self.name, **FWD)
            return
        for g in got:  # every rank reports the same loss and parameters
            np.testing.assert_allclose(g[self.index]["loss"], self.want_loss, rtol=1e-5,
                                       err_msg=self.name)
        state = got[0][self.index]["state"]
        assert set(state) == set(self.want_state), self.name
        for k, v in state.items():
            if k.endswith("num_batches_tracked"):  # torch's counter: JAX keeps none
                assert v == 1, k
                continue
            np.testing.assert_allclose(v, self.want_state[k], err_msg=f"{self.name} {k}",
                                       **STEP)
        for g in got[1:]:
            for k, v in g[self.index]["state"].items():
                np.testing.assert_array_equal(v, state[k], err_msg=f"{self.name} {k}")


def _cases(d):
    if d == 2:
        return [
            Case("halo", 2), Case("allgather", 2, exchange="allgather"),
            Case("res", 2, n=700, block="res"), Case("plain", 2, n=700, block="plain"),
            Case("band softmax_sg", 2, n=1200, e=7000, local=True, band="auto",
                 aggr="softmax_sg", t=0.8),
            Case("band mean", 2, n=1200, e=7000, local=True, band="auto", aggr="mean"),
            Case("step layer norm", 2, n=640, step=True, num_layers=2, seed=2),
            Case("step band learn_t", 2, n=640, e=4000, local=True, band="auto", step=True,
                 num_layers=2, aggr="softmax", learn_t=True, t=0.8, seed=8),
        ]
    return [
        Case("halo edge features", 3, n=700, edge_dim=6, seed=1),
        Case("allgather edge features", 3, n=700, edge_dim=6, seed=1, exchange="allgather"),
        Case("band power", 3, n=1200, e=7000, local=True, band="auto", aggr="power",
             p=1.5),
        Case("band softmax_sum", 3, n=1200, e=7000, local=True, band="auto",
             aggr="softmax_sum", y=0.5),
        Case("step batch norm uneven", 3, n=900, step=True, num_layers=2, norm="batch",
             seed=4),
        Case("step halo sum", 3, n=800, step=True, num_layers=2, aggr="add", seed=5),
    ]


NAMES = {2: ["halo", "allgather", "res", "plain", "band softmax_sg", "band mean",
             "step layer norm", "step band learn_t"],
         3: ["halo edge features", "allgather edge features", "band power",
             "band softmax_sum", "step batch norm uneven", "step halo sum"]}
_RUNS = {}


def _run(d):
    """The JAX side of every case of D ranks, and one spawn of the port's
    ranks running them all (with the adjointness case first)."""
    if d not in _RUNS:
        cases = {c.name: c for c in _cases(d)}
        assert list(cases) == NAMES[d]
        port = [dict(kind="adjoint", rows=8, c=4)]
        for i, c in enumerate(cases.values()):
            c.index = i + 1
            port.append(c.port)
        _RUNS[d] = cases, launch(tpc.run_cases, d, (port,), deadline=torch_budget.SUBPROCESS_S)
    return _RUNS[d]


@pytest.mark.parametrize("d", [2, 3])
def test_ranks_import_no_jax(d):
    assert all(rk["jax_free"] for rk in _run(d)[1])


@pytest.mark.parametrize("d", [2, 3])
def test_collectives_are_adjoint(d):
    """⟨A x, y⟩ = ⟨x, Aᵀ y⟩ summed over the ranks, Aᵀ the backward."""
    out = _run(d)[1]
    res = out[0]["results"][0]
    assert set(res) == {f"ppermute{k}" for k in range(1, d)} | {"all_gather",
                                                                 "all_reduce_sum"}
    for name, (lhs, rhs) in res.items():
        assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs)), (name, lhs, rhs)
    assert all(rk["results"][0] == res for rk in out)


@pytest.mark.parametrize("d,name", [(d, n) for d in (2, 3) for n in NAMES[d]])
def test_spatial_matches_jax(d, name):
    cases, out = _run(d)
    cases[name].check(out)


def test_batch_norm_split_is_uneven():
    """The BatchNorm case's shards hold unequal valid rows, one none."""
    s, r, *_ = _graph(900, 5000, 16, seed=4)
    sh = shard_graph(s, r, 900, 3)
    assert sh.node_mask.sum(1).tolist() == [512, 388, 0]


def test_uneven_batch_norm_differs_from_single_chip():
    """JAX's equal-weight moments on the uneven split are not the
    single-chip moments (the quirk the port mirrors): the cross-rank mean
    of the per-rank means differs from the global mean."""
    x = np.random.default_rng(0).standard_normal((900, 4)).astype(np.float32) + 1.0
    sh = shard_graph(np.zeros(1, np.int64), np.zeros(1, np.int64), 900, 3)
    xs, m = shard_nodes(x, sh), sh.node_mask
    per = [xs[d][m[d]].mean(0) if m[d].any() else np.zeros(4, np.float32) for d in range(3)]
    assert not np.allclose(np.mean(per, 0), x.mean(0), rtol=1e-2)
