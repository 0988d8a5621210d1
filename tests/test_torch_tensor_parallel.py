"""`TPDeeperGCN` and `tp_train_step` on 4 gloo ranks against the JAX
package's `tp_forward` / `tp_train_step` under `shard_map` on 4 of
conftest's virtual CPU devices, on the same numpy inputs and weights
(carried across by `utils.import_jax`), and the collectives over the
subgroups of a 2 × 2 grid.

One spawn of 4 ranks runs every case: the adjoint identity of each
collective over the gp and the tp groups (`psum_scatter` and the
replicated sum among them), forwards with the softmax, softmax_sg, mean
and max aggregators under batch norm and softmax under layer norm, and SGD
steps with batch and layer norms, a two-layer MLP, a learned t (its
gradient, partial on each rank, summed over tp) and ``remat`` (each layer
recomputed in the backward, its `psum_scatter`s issued again). Tolerances are
tests/test_tensor_parallel.py's: forward rtol 2e-4 / atol 2e-5, loss rtol
1e-5, updated parameters rtol 4e-4 / atol 4e-5 (5e-4 / 5e-5 with
mlp_layers=2). The host-side pieces (the shard layout against JAX's slices,
the round trip, the refusals) run without ranks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_cases as tpc
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu.parallel import TPDeeperGCN as JaxTP
from deep_gcns_torch_tpu.parallel import make_mesh
from deep_gcns_torch_tpu.parallel import shard_deeper_params as jax_shard
from deep_gcns_torch_tpu.parallel import tp_forward as jax_tp_forward
from deep_gcns_torch_tpu.parallel import tp_train_step as jax_tp_step
from deep_gcns_torch_tpu.parallel import unshard_deeper_params as jax_unshard
from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.models import DeeperGCNConfig
from deep_gcns_torch_tpu_torch.parallel import (check_tp_supported, launch, shard_deeper_params,
                                                unshard_deeper_params)
from deep_gcns_torch_tpu_torch.utils.import_jax import deeper_gcn_state_dict_from_jax
import torch_budget
from torch_budget import budget  # noqa: F401

N_DEV = 4
FWD = dict(rtol=2e-4, atol=2e-5)
STEP = dict(rtol=4e-4, atol=4e-5)
STEP_MLP2 = dict(rtol=5e-4, atol=5e-5)
BASE = dict(in_channels=16, hidden_channels=32, num_tasks=8, num_layers=3, block="res+",
            aggr="softmax", t=0.5, norm="batch", mlp_layers=1, dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(seed, n=512, e=3000):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    return jax_build_graph(x, s, r, num_nodes=n), build_graph(x, s, r, num_nodes=n), rng


def _nll(logits, lab, mask):
    logp = jax.nn.log_softmax(logits, -1)
    nll = -jnp.take_along_axis(logp, lab[:, None], 1)[:, 0]
    m = mask.astype(nll.dtype)
    return jnp.sum(nll * m) / jnp.sum(m)


def _port_sd(params, state, cfg):
    return {k: v.numpy() for k, v in deeper_gcn_state_dict_from_jax(params, state, cfg).items()}


class Case:
    """One configuration: the JAX side now, the port's case dict for the
    ranks, and the comparison once they are back."""

    def __init__(self, name, step=False, seed=0, tol=STEP, **cfg):
        self.name, self.step, self.tol = name, step, tol
        jcfg = JaxConfig(**dict(BASE, **cfg))
        g, pg, rng = _graphs(seed)
        single = JaxDeeperGCN(jcfg)
        params, state = _np(jax.jit(single.init)(jax.random.PRNGKey(seed)))
        self.port = dict(kind="tp_deeper", cfg=dict(BASE, **cfg), graph=pg,
                         state=_port_sd(params, state, jcfg))
        p_tp, s_tp = jax_shard(params, state, N_DEV, jcfg)
        p_tp, s_tp = (jax.tree_util.tree_map(jnp.asarray, a) for a in (p_tp, s_tp))
        mesh = make_mesh(("tp",), devices=jax.devices()[:N_DEV])
        model = JaxTP(jcfg)
        if not step:
            self.want = np.asarray(jax_tp_forward(model, mesh)(p_tp, s_tp, g.x, g))
            return
        labels = rng.integers(0, 8, g.num_nodes_padded)
        tx = optax.sgd(0.05)
        p2, s2, _, loss = jax_tp_step(model, tx, _nll, mesh)(
            p_tp, s_tp, tx.init(p_tp), g.x, g, jnp.asarray(labels), jax.random.PRNGKey(1))
        self.want_loss = float(loss)
        self.want_state = _port_sd(*jax_unshard(_np(p2), _np(s2)), jcfg)
        self.port.update(lr=0.05, labels=labels)

    def check(self, ranks):
        got = [rk["results"][self.index] for rk in ranks]
        if not self.step:
            for g in got:  # every rank holds the replicated logits
                np.testing.assert_allclose(g["logits"], self.want, err_msg=self.name, **FWD)
            return
        for g in got:
            np.testing.assert_allclose(g["loss"], self.want_loss, rtol=1e-5, err_msg=self.name)
        state = got[0]["state"]
        assert set(state) == set(self.want_state), self.name
        for k, v in state.items():
            if k.endswith("num_batches_tracked"):  # torch's counter: JAX keeps none
                assert v == 1, k
                continue
            np.testing.assert_allclose(v, self.want_state[k], err_msg=f"{self.name} {k}",
                                       **self.tol)
        for g in got[1:]:
            for k, v in g["state"].items():
                np.testing.assert_array_equal(v, state[k], err_msg=f"{self.name} {k}")


def _cases():
    return [
        Case("softmax batch"), Case("softmax_sg batch", aggr="softmax_sg"),
        Case("mean batch", aggr="mean"), Case("max batch", aggr="max", seed=3),
        Case("softmax layer", norm="layer"),
        Case("step batch", step=True), Case("step layer", step=True, norm="layer"),
        Case("step mlp2 batch", step=True, mlp_layers=2, tol=STEP_MLP2),
        Case("step mlp2 layer", step=True, mlp_layers=2, norm="layer", tol=STEP_MLP2),
        Case("step learn_t", step=True, learn_t=True, seed=5),
        Case("step remat", step=True, remat=True, seed=6),
    ]


NAMES = ["softmax batch", "softmax_sg batch", "mean batch", "max batch", "softmax layer",
         "step batch", "step layer", "step mlp2 batch", "step mlp2 layer", "step learn_t",
         "step remat"]
ADJOINT_OPS = {"ppermute1", "all_gather", "psum_scatter", "all_reduce_sum",
               "all_reduce_replicated"}
_RUN = {}


def _run():
    """The JAX side of every case and one spawn of 4 ranks running them all,
    the grid adjoint case first."""
    if not _RUN:
        cases = {c.name: c for c in _cases()}
        assert list(cases) == NAMES
        port = [dict(kind="adjoint", grid=(2, 2), rows=8, c=6)]
        for i, c in enumerate(cases.values()):
            c.index = i + 1
            port.append(c.port)
        _RUN["out"] = cases, launch(tpc.run_cases, N_DEV, (port,),
                                    deadline=torch_budget.SUBPROCESS_S)
    return _RUN["out"]


def test_ranks_import_no_jax():
    assert all(rk["jax_free"] for rk in _run()[1])


@pytest.mark.parametrize("axis", ["gp", "tp"])
def test_collectives_on_subgroups_are_adjoint(axis):
    """⟨A x, y⟩ = ⟨x, Aᵀ y⟩ over each axis's group of a 2 × 2 grid, Aᵀ the
    backward: the halo permute, the all-gather (reduce-scatter backward),
    `psum_scatter` (all-gather backward), the sum with an all-reduce
    backward and the replicated sum with the identity backward."""
    out = _run()[1]
    for rk in out:
        res = {k.split(":")[1]: v for k, v in rk["results"][0].items()
               if k.startswith(axis + ":")}
        assert set(res) == ADJOINT_OPS
        for name, (lhs, rhs) in res.items():
            assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs)), (axis, name, lhs, rhs)


@pytest.mark.parametrize("name", NAMES)
def test_tp_matches_jax(name):
    cases, out = _run()
    cases[name].check(out)


def _jax_and_port(seed=0, **cfg):
    jcfg = JaxConfig(**dict(BASE, **cfg))
    params, state = _np(jax.jit(JaxDeeperGCN(jcfg).init)(jax.random.PRNGKey(seed)))
    sd = {k: v for k, v in deeper_gcn_state_dict_from_jax(params, state, jcfg).items()}
    return jcfg, params, state, sd, DeeperGCNConfig(**dict(BASE, **cfg))


@pytest.mark.parametrize("cfg", [dict(), dict(mlp_layers=2), dict(norm="layer", learn_t=True)],
                         ids=["mlp1 batch", "mlp2 batch", "layer learn_t"])
def test_shard_matches_jax_slices(cfg):
    """Rank d's `state_dict` from `shard_deeper_params` equals JAX's slice d
    of `shard_deeper_params`, carried across leaf by leaf, and unsharding
    gives the single-process `state_dict` back exactly."""
    jcfg, params, state, sd, pcfg = _jax_and_port(**cfg)
    p_tp, s_tp = jax_shard(params, state, N_DEV, jcfg)
    mine = shard_deeper_params(sd, N_DEV, pcfg)
    for d in range(N_DEV):
        pick = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a)[d], tree)  # noqa
        want = deeper_gcn_state_dict_from_jax(pick(p_tp), pick(s_tp), jcfg)
        assert set(want) == set(mine[d])
        for k, v in want.items():
            np.testing.assert_array_equal(mine[d][k].numpy(), v.numpy(), err_msg=f"{d} {k}")
    back = unshard_deeper_params(mine, pcfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("bad", [dict(mlp_layers=3), dict(norm="instance"), dict(block="res"),
                                 dict(msg_norm=True), dict(use_one_hot_encoding=True),
                                 dict(edge_mode="one_time", edge_feat_dim=4)],
                         ids=["mlp3", "instance", "res", "msg_norm", "one_hot", "edges"])
def test_tp_refuses_unsupported(bad):
    """JAX's asserts (`tensor.py:95-105`) raise ValueError here, and so do
    the inputs its sharding does not cover."""
    with pytest.raises(ValueError):
        check_tp_supported(dataclasses.replace(DeeperGCNConfig(**BASE), **bad))
