"""`TPRevGCN` and `tp_rev_train_step` on 4 gloo ranks against the JAX
package's `tp_rev_forward` / `tp_rev_train_step` under `shard_map` on 4 of
conftest's virtual CPU devices, on the same numpy inputs and weights
(carried across by `utils.import_jax`).

One spawn of 4 ranks runs every case: forwards with and without edge
features, an SGD step with edge features and dropout (JAX's `make_tp_mask`
masks, split group-major on each rank) and one without either, and a step
whose masks the port's `make_tp_mask` draws, against the single-process
RevGCN's step on the same generator seed. Tolerances are
tests/test_tensor_rev.py's: forward rtol 2e-4 / atol 2e-5, loss rtol 1e-5,
updated parameters rtol 3e-4 / atol 3e-5. The shard layout against JAX's
slices, the round trip and the refusals run without ranks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_cases as tpc
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.models import RevGCN as JaxRevGCN
from deep_gcns_torch_tpu.models import RevGCNConfig as JaxConfig
from deep_gcns_torch_tpu.parallel import TPRevGCN as JaxTPRev
from deep_gcns_torch_tpu.parallel import make_mesh
from deep_gcns_torch_tpu.parallel import make_tp_mask as jax_make_tp_mask
from deep_gcns_torch_tpu.parallel import shard_rev_params as jax_shard
from deep_gcns_torch_tpu.parallel import tp_rev_forward as jax_tp_forward
from deep_gcns_torch_tpu.parallel import tp_rev_train_step as jax_tp_step
from deep_gcns_torch_tpu.parallel import unshard_rev_params as jax_unshard
from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.models import RevGCNConfig
from deep_gcns_torch_tpu_torch.parallel import (check_tp_rev_supported, launch,
                                                shard_rev_params, unshard_rev_params)
from deep_gcns_torch_tpu_torch.utils.import_jax import rev_gcn_state_dict_from_jax
import torch_budget
from torch_budget import budget  # noqa: F401

N_DEV = 4
FWD = dict(rtol=2e-4, atol=2e-5)
STEP = dict(rtol=3e-4, atol=3e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(aggr="softmax", edge_dim=0, dropout=0.0):
    """tests/test_tensor_rev.py's `setup` config, as keyword arguments."""
    return dict(in_channels=8, node_feat_dim=8, edge_feat_dim=edge_dim, hidden_channels=32,
                num_tasks=6, num_layers=3, group=2, aggr=aggr, norm="layer", mlp_layers=1,
                dropout=dropout, conv_encode_edge=edge_dim > 0, use_one_hot_encoding=True)


def _nll(logits, labels, node_mask):
    logp = jax.nn.log_softmax(logits, -1)
    nll = -jnp.take_along_axis(logp, labels[:, None], 1)[:, 0]
    m = node_mask.astype(nll.dtype)
    return jnp.sum(nll * m) / jnp.sum(m)


class Case:
    def __init__(self, name, step=False, seed=0, port_masks=False, n=384, e=2200, **kw):
        self.name, self.step = name, step
        cfg = _cfg(**kw)
        jcfg = JaxConfig(**cfg)
        rng = np.random.default_rng(seed)
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        x = rng.standard_normal((n, 8)).astype(np.float32)
        edge_dim = cfg["edge_feat_dim"]
        ea = rng.standard_normal((e, edge_dim)).astype(np.float32) if edge_dim else None
        g = jax_build_graph(x, s, r, num_nodes=n, edge_attr=ea)
        pg = build_graph(x, s, r, num_nodes=n, edge_attr=ea)
        params = _np(jax.jit(JaxRevGCN(jcfg).init)(jax.random.PRNGKey(seed))[0])
        n_pad = g.num_nodes_padded
        nf = rng.standard_normal((n_pad, 8)).astype(np.float32)
        sp = np.eye(8, dtype=np.float32)[rng.integers(0, 8, n_pad)]
        sd = {k: v.numpy() for k, v in rev_gcn_state_dict_from_jax(params, jcfg).items()}
        self.port = dict(kind="tp_rev", cfg=cfg, graph=pg, state=sd, species=sp, nf=nf)
        if port_masks:
            # the port's own draw, against its single-process step (no JAX)
            self.port.update(lr=0.05, labels=rng.integers(0, 6, n_pad), mask_seed=11)
            return
        p_tp = jax.tree_util.tree_map(jnp.asarray, jax_shard(params, N_DEV, jcfg))
        mesh = make_mesh(("tp",), devices=jax.devices()[:N_DEV])
        model = JaxTPRev(jcfg)
        if not step:
            self.want = np.asarray(jax_tp_forward(model, mesh)(p_tp, jnp.asarray(sp),
                                                               jnp.asarray(nf), g))
            return
        labels = rng.integers(0, 6, n_pad)
        key = jax.random.PRNGKey(5)
        mask_tp, head_tp = jax_make_tp_mask(jcfg, key, n_pad, N_DEV)
        tx = optax.sgd(0.05)
        p2, _, loss = jax_tp_step(model, tx, _nll, mesh)(
            p_tp, tx.init(p_tp), jnp.asarray(sp), jnp.asarray(nf), g, jnp.asarray(labels),
            mask_tp, head_tp)
        self.want_loss = float(loss)
        self.want_state = {k: v.numpy() for k, v in rev_gcn_state_dict_from_jax(
            jax_unshard(_np(p2), jcfg), jcfg).items()}
        masks = None
        if mask_tp is not None:
            # JAX's per-device grouped slices back to full [N, C] masks
            from deep_gcns_torch_tpu.parallel.tensor_rev import _cat_grouped

            masks = tuple(_cat_grouped(np.asarray(m), 1, jcfg.group)
                          for m in (mask_tp, head_tp))
        self.port.update(lr=0.05, labels=labels, masks=masks)

    def check(self, ranks):
        got = [rk["results"][self.index] for rk in ranks]
        if not self.step:
            for g in got:
                np.testing.assert_allclose(g["logits"], self.want, err_msg=self.name, **FWD)
            return
        if "single" in got[0]:
            self.want_loss, self.want_state = got[0]["single"]
        for g in got:
            np.testing.assert_allclose(g["loss"], self.want_loss, rtol=1e-5, err_msg=self.name)
        state = got[0]["state"]
        assert set(state) == set(self.want_state), self.name
        for k, v in state.items():
            np.testing.assert_allclose(v, self.want_state[k], err_msg=f"{self.name} {k}",
                                       **STEP)
        for g in got[1:]:
            for k, v in g["state"].items():
                np.testing.assert_array_equal(v, state[k], err_msg=f"{self.name} {k}")


def _cases():
    return [
        Case("forward softmax"), Case("forward mean edge features", aggr="mean", edge_dim=4),
        Case("step edge features dropout", step=True, edge_dim=4, dropout=0.3),
        Case("step softmax_sg", step=True, aggr="softmax_sg", seed=2),
        Case("step make_tp_mask vs single process", step=True, port_masks=True, edge_dim=4,
             dropout=0.3, seed=3),
    ]


NAMES = ["forward softmax", "forward mean edge features", "step edge features dropout",
         "step softmax_sg", "step make_tp_mask vs single process"]
_RUN = {}


def _run():
    if not _RUN:
        cases = {c.name: c for c in _cases()}
        assert list(cases) == NAMES
        for i, c in enumerate(cases.values()):
            c.index = i
        _RUN["out"] = cases, launch(tpc.run_cases, N_DEV, ([c.port for c in cases.values()],),
                                    deadline=torch_budget.SUBPROCESS_S)
    return _RUN["out"]


def test_ranks_import_no_jax():
    assert all(rk["jax_free"] for rk in _run()[1])


@pytest.mark.parametrize("name", NAMES)
def test_tp_rev_matches(name):
    cases, out = _run()
    cases[name].check(out)


@pytest.mark.parametrize("edge_dim", [0, 4])
def test_shard_matches_jax_slices(edge_dim):
    """Rank d's `state_dict` from `shard_rev_params` equals JAX's slice d of
    `shard_rev_params` (group-major layout), carried across leaf by leaf;
    unsharding gives the single-process `state_dict` back exactly."""
    jcfg = JaxConfig(**_cfg(edge_dim=edge_dim))
    params = _np(jax.jit(JaxRevGCN(jcfg).init)(jax.random.PRNGKey(1))[0])
    sd = rev_gcn_state_dict_from_jax(params, jcfg)
    p_tp = jax_shard(params, N_DEV, jcfg)
    mine = shard_rev_params(sd, N_DEV, RevGCNConfig(**_cfg(edge_dim=edge_dim)))
    for d in range(N_DEV):
        want = rev_gcn_state_dict_from_jax(
            jax.tree_util.tree_map(lambda a: np.asarray(a)[d], p_tp), jcfg)
        assert set(want) == set(mine[d])
        for k, v in want.items():
            np.testing.assert_array_equal(mine[d][k].numpy(), v.numpy(), err_msg=f"{d} {k}")
    back = unshard_rev_params(mine, RevGCNConfig(**_cfg(edge_dim=edge_dim)))
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("bad", [dict(mlp_layers=2), dict(conv="gat"), dict(msg_norm=True),
                                 dict(norm="batch")], ids=["mlp2", "gat", "msg_norm", "batch"])
def test_tp_rev_refuses_unsupported(bad):
    with pytest.raises(ValueError):
        check_tp_rev_supported(dataclasses.replace(RevGCNConfig(**_cfg()), **bad))
