"""`SpatialTPDeeperGCN` and `spatial_tp_train_step` on a 2 × 2 grid of gloo
ranks (nodes over gp, channels over tp) against the JAX package's
`spatial_tp_forward` / `spatial_tp_train_step` under `shard_map` on a
("gp", "tp") mesh of 4 of conftest's virtual CPU devices, on the same
numpy inputs and weights (carried across by `utils.import_jax`).

One spawn of 4 ranks runs every case: forwards with batch and layer norms
on the halo exchange and on the all-gather, and SGD steps with batch norm
(its moments across gp only, JAX's equal weights on the 512/488 split) and
with layer norm and a two-layer MLP. Tolerances are
tests/test_spatial_tp.py's: forward rtol 3e-4 / atol 3e-5, loss rtol 1e-5,
updated parameters rtol 5e-4 / atol 5e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_cases as tpc
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu.parallel import SpatialTPDeeperGCN as JaxSpatialTP
from deep_gcns_torch_tpu.parallel import make_mesh
from deep_gcns_torch_tpu.parallel import shard_deeper_params as jax_shard_params
from deep_gcns_torch_tpu.parallel import shard_graph as jax_shard_graph
from deep_gcns_torch_tpu.parallel import spatial_tp_forward as jax_forward
from deep_gcns_torch_tpu.parallel import spatial_tp_train_step as jax_step
from deep_gcns_torch_tpu.parallel import unshard_deeper_params as jax_unshard
from deep_gcns_torch_tpu_torch.parallel import launch, shard_graph, shard_nodes
from deep_gcns_torch_tpu_torch.utils.import_jax import deeper_gcn_state_dict_from_jax
import torch_budget
from torch_budget import budget  # noqa: F401

GP, TP = 2, 2
FWD = dict(rtol=3e-4, atol=3e-5)
STEP = dict(rtol=5e-4, atol=5e-5)
BASE = dict(in_channels=16, hidden_channels=32, num_tasks=8, num_layers=3, block="res+",
            aggr="softmax", t=0.5, norm="batch", mlp_layers=1, dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sum_nll(logits, lab, m):
    logp = jax.nn.log_softmax(logits, -1)
    nll = -jnp.take_along_axis(logp, lab[:, None], 1)[:, 0]
    m = m.astype(nll.dtype)
    return jnp.sum(nll * m), jnp.sum(m)


class Case:
    def __init__(self, name, exchange="halo", step=False, seed=0, n=1000, e=6000, **cfg):
        self.name, self.step, self.n = name, step, n
        kw = dict(BASE, **cfg)
        jcfg = JaxConfig(**kw)
        rng = np.random.default_rng(seed)
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        x = rng.standard_normal((n, 16)).astype(np.float32)
        params, state = _np(jax.jit(JaxDeeperGCN(jcfg).init)(jax.random.PRNGKey(seed)))
        sh = shard_graph(s, r, n, GP)
        jsh = jax_shard_graph(s, r, n, GP)
        xs = shard_nodes(x, sh)
        sd = {k: v.numpy() for k, v in deeper_gcn_state_dict_from_jax(params, state,
                                                                      jcfg).items()}
        self.port = dict(kind="spatial_tp", grid=(GP, TP), cfg=kw, exchange=exchange,
                         shards=sh, x=xs, state=sd)
        p_tp, s_tp = (jax.tree_util.tree_map(jnp.asarray, a)
                      for a in jax_shard_params(params, state, TP, jcfg))
        mesh = make_mesh(("gp", "tp"), shape=(GP, TP), devices=jax.devices()[:GP * TP])
        model = JaxSpatialTP(jcfg, exchange=exchange)
        if not step:
            out = jax_forward(model, mesh)(p_tp, s_tp, jnp.asarray(xs), jax.device_put(jsh))
            self.want = np.asarray(out).reshape(-1, kw["num_tasks"])[:n]
            return
        labels = rng.integers(0, 8, n)
        lab = shard_nodes(labels[:, None].astype(np.int32), sh)[..., 0]
        mask = np.asarray(sh.node_mask) & shard_nodes((np.arange(n) % 3 != 0)[:, None],
                                                      sh)[..., 0]
        tx = optax.sgd(0.05)
        p2, s2, _, loss = jax_step(model, tx, _sum_nll, mesh)(
            p_tp, s_tp, tx.init(p_tp), jnp.asarray(xs), jax.device_put(jsh), jnp.asarray(lab),
            jnp.asarray(mask), jax.random.PRNGKey(1))
        self.want_loss = float(loss)
        self.want_state = {k: v.numpy() for k, v in deeper_gcn_state_dict_from_jax(
            *jax_unshard(_np(p2), _np(s2)), jcfg).items()}
        self.port.update(lr=0.05, labels=lab, mask=mask)

    def check(self, ranks):
        got = [rk["results"][self.index] for rk in ranks]
        if not self.step:
            for g in got:  # every rank holds the gathered logits
                np.testing.assert_allclose(g["logits"][:self.n], self.want, err_msg=self.name,
                                           **FWD)
            return
        for g in got:
            np.testing.assert_allclose(g["loss"], self.want_loss, rtol=1e-5, err_msg=self.name)
        state = got[0]["state"]
        assert set(state) == set(self.want_state), self.name
        for k, v in state.items():
            if k.endswith("num_batches_tracked"):
                assert v == 1, k
                continue
            np.testing.assert_allclose(v, self.want_state[k], err_msg=f"{self.name} {k}",
                                       **STEP)
        for g in got[1:]:
            for k, v in g["state"].items():
                np.testing.assert_array_equal(v, state[k], err_msg=f"{self.name} {k}")


def _cases():
    return [
        Case("forward batch halo"), Case("forward layer halo", norm="layer"),
        Case("forward batch allgather", exchange="allgather"),
        Case("forward layer allgather", exchange="allgather", norm="layer", seed=1),
        Case("step batch halo", step=True),
        Case("step layer mlp2 allgather", step=True, exchange="allgather", norm="layer",
             mlp_layers=2, seed=2),
        Case("step batch mlp2 halo learn_t", step=True, mlp_layers=2, learn_t=True, seed=3),
    ]


NAMES = ["forward batch halo", "forward layer halo", "forward batch allgather",
         "forward layer allgather", "step batch halo", "step layer mlp2 allgather",
         "step batch mlp2 halo learn_t"]
_RUN = {}


def _run():
    if not _RUN:
        cases = {c.name: c for c in _cases()}
        assert list(cases) == NAMES
        for i, c in enumerate(cases.values()):
            c.index = i
        _RUN["out"] = cases, launch(tpc.run_cases, GP * TP,
                                    ([c.port for c in cases.values()],),
                                    deadline=torch_budget.SUBPROCESS_S)
    return _RUN["out"]


def test_ranks_import_no_jax():
    assert all(rk["jax_free"] for rk in _run()[1])


@pytest.mark.parametrize("name", NAMES)
def test_spatial_tp_matches_jax(name):
    cases, out = _run()
    cases[name].check(out)

