"""`SpatialRevGCN` (GEN, GCN, SAGE and GAT group functions) and cluster data
parallelism on gloo ranks against the JAX package's `spatial_rev` and
`cluster_dp_train_step` under `shard_map` on conftest's virtual CPU
devices, on the same numpy inputs and weights. Cluster DP is also held
against the port's own sequential mean-of-cluster-losses step, as
tests/test_rev_multichip.py holds JAX's. One spawn per D runs every case.
Tolerances: tests/test_spatial.py's (forward rtol 2e-4 / atol 2e-5,
parameters after an SGD step rtol 3e-4 / atol 3e-5); the DP step
tests/test_rev_multichip.py's (loss rtol 1e-5, parameters rtol 1e-4 /
atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_cases as tpc
from deep_gcns_torch_tpu.data.synthetic import random_node_graph as jax_random_graph
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxDeeperConfig
from deep_gcns_torch_tpu.models.rev_gcn import RevGCNConfig as JaxRevConfig
from deep_gcns_torch_tpu.parallel import cluster_dp_train_step as jax_dp_step
from deep_gcns_torch_tpu.parallel.data_parallel import stack_shards
from deep_gcns_torch_tpu.parallel.mesh import make_mesh
from deep_gcns_torch_tpu.parallel.spatial import shard_graph as jax_shard_graph
from deep_gcns_torch_tpu.parallel.spatial_rev import SpatialRevGCN as JaxSpatialRev
from deep_gcns_torch_tpu.parallel.spatial_rev import spatial_rev_forward as jax_rev_forward
from deep_gcns_torch_tpu.parallel.spatial_rev import spatial_rev_train_step as jax_rev_step
from deep_gcns_torch_tpu.utils.loss import cross_entropy as jax_cross_entropy
from deep_gcns_torch_tpu_torch.data.synthetic import random_node_graph
from deep_gcns_torch_tpu_torch.models import RevGCN, RevGCNConfig
from deep_gcns_torch_tpu_torch.parallel import launch, shard_graph, shard_nodes
from deep_gcns_torch_tpu_torch.utils.import_jax import (deeper_gcn_state_dict_from_jax,
                                                        rev_gcn_state_dict_from_jax)
from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy
import torch_budget
from torch_budget import budget  # noqa: F401

FWD = dict(rtol=2e-4, atol=2e-5)
STEP = dict(rtol=3e-4, atol=3e-5)
DP = dict(rtol=1e-4, atol=1e-5)
REV = dict(in_channels=8, node_feat_dim=8, edge_feat_dim=8, hidden_channels=16, num_tasks=5,
           num_layers=3, group=2, aggr="softmax", t=0.7, dropout=0.0, norm="layer",
           use_one_hot_encoding=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nll(logits, lab, m):
    logp = jax.nn.log_softmax(logits, -1)
    nll = -jnp.take_along_axis(logp, lab[:, None], 1)[:, 0]
    m = m.astype(nll.dtype)
    return jnp.sum(nll * m), jnp.sum(m)


class RevCase:
    def __init__(self, name, d, conv="gen", exchange="halo", step=False, n=700, e=4000,
                 seed=0, **cfg):
        self.name, self.n, self.step = name, n, step
        kw = dict(REV, conv=conv, **cfg)
        if conv == "gat":
            kw["heads"] = 2
        rng = np.random.default_rng(seed)
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        ea = rng.standard_normal((e, 8)).astype(np.float32) if conv == "gen" else None
        x = np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)]
        nf = rng.standard_normal((n, 8)).astype(np.float32)
        labels = rng.integers(0, 5, n)
        jcfg = JaxRevConfig(**kw)
        model = JaxSpatialRev(jcfg, exchange=exchange)
        params, _ = jax.jit(model.init)(jax.random.PRNGKey(seed))
        params = _np(params)
        jsh = jax_shard_graph(s, r, n, d, edge_attr=ea)
        sh = shard_graph(s, r, n, d, edge_attr=ea)
        xs, nfs = shard_nodes(x, sh), shard_nodes(nf, sh)
        mesh = make_mesh(("gp",), devices=jax.devices()[:d])
        sd = {k: v.numpy() for k, v in rev_gcn_state_dict_from_jax(params, jcfg).items()}
        self.port = dict(kind="rev", cfg=kw, exchange=exchange, state=sd, shards=sh, x=xs,
                         nf=nfs)
        if not step:
            out = jax_rev_forward(model, mesh)(params, jnp.asarray(xs), jnp.asarray(nfs),
                                               jax.device_put(jsh))
            self.want = np.asarray(out).reshape(-1, 5)[:n]
            return
        lab = shard_nodes(labels[:, None].astype(np.int32), sh)[..., 0]
        mask = np.asarray(sh.node_mask) & shard_nodes((np.arange(n) % 4 != 1)[:, None],
                                                      sh)[..., 0]
        self.port.update(lr=0.1, labels=lab, mask=mask)
        tx = optax.sgd(0.1)
        p2, _, loss = jax_rev_step(model, tx, _nll, mesh)(
            params, tx.init(params), jnp.asarray(xs), jnp.asarray(nfs), jax.device_put(jsh),
            jnp.asarray(lab), jnp.asarray(mask), jax.random.PRNGKey(5))
        self.want_loss = float(loss)
        self.want_state = {k: v.numpy() for k, v in
                           rev_gcn_state_dict_from_jax(_np(p2), jcfg).items()}

    def check(self, got):
        if not self.step:
            out = np.concatenate([g[self.index]["logits"] for g in got])[:self.n]
            np.testing.assert_allclose(out, self.want, err_msg=self.name, **FWD)
            return
        for g in got:
            np.testing.assert_allclose(g[self.index]["loss"], self.want_loss, rtol=1e-5)
        state = got[0][self.index]["state"]
        assert set(state) == set(self.want_state)
        for k, v in state.items():
            np.testing.assert_allclose(v, self.want_state[k], err_msg=f"{self.name} {k}",
                                       **STEP)


def _clusters(d):
    """D proteins-shaped clusters (48 nodes of 64 padded, edge features)
    built alike by both packages."""
    out = []
    for i in range(d):
        gj, lab = jax_random_graph(np.random.default_rng(20 + i), 48, 4, 8, num_classes=5,
                                   edge_dim=8, node_pad=64, edge_pad=256)
        gt, lab_t = random_node_graph(np.random.default_rng(20 + i), 48, 4, 8, num_classes=5,
                                      edge_dim=8, node_pad=64, edge_pad=256)
        np.testing.assert_array_equal(lab, lab_t)
        out.append((gj, gt, np.pad(lab, (0, 16)).astype(np.int64)))
    return out


class DPCase:
    """One cluster-DP SGD step of a RevGCN (LayerNorm) or a DeeperGCN
    (BatchNorm across ranks) against JAX's `cluster_dp_train_step`; the
    RevGCN also against the port's sequential mean of the cluster losses."""

    def __init__(self, name, d, model):
        self.name, self.model = name, model
        clusters = _clusters(d)
        if model == "rev":
            kw = dict(REV, use_one_hot_encoding=False, num_layers=4, aggr="softmax")
            jcfg = JaxRevConfig(**kw)
            from deep_gcns_torch_tpu.models.rev_gcn import RevGCN as JaxRevGCN
            jm = JaxRevGCN(jcfg)
        else:
            kw = dict(in_channels=8, hidden_channels=16, num_tasks=5, num_layers=3,
                      block="res+", aggr="softmax_sg", t=0.5, norm="batch", dropout=0.0,
                      edge_mode="per_layer", edge_feat_dim=8)
            jcfg = JaxDeeperConfig(**kw)
            jm = JaxDeeperGCN(jcfg)
        params, state = jax.jit(jm.init)(jax.random.PRNGKey(3))
        params, state = _np(params), _np(state)
        conv = ((lambda p, s: rev_gcn_state_dict_from_jax(p, jcfg)) if model == "rev" else
                (lambda p, s: deeper_gcn_state_dict_from_jax(p, s, jcfg)))
        self.sd = {k: v.numpy() for k, v in conv(params, state).items()}
        self.kw, self.clusters = kw, clusters
        self.port = dict(kind="dp", model=model, cfg=kw, state=self.sd, lr=0.1,
                         graphs=[c[1] for c in clusters], labels=[c[2] for c in clusters])
        tx = optax.sgd(0.1)
        mesh = make_mesh(("dp",), devices=jax.devices()[:d])
        step = jax_dp_step(jm, tx, jax_cross_entropy, mesh, axis="dp", donate=False)
        p2, s2, _, loss = step(params, state, tx.init(params),
                               stack_shards([c[0] for c in clusters]),
                               jnp.asarray(np.stack([c[2] for c in clusters]).astype(np.int32)),
                               jax.random.PRNGKey(7))
        self.want_loss = float(loss)
        self.want_state = {k: v.numpy() for k, v in conv(_np(p2), _np(s2)).items()}

    def sequential(self):
        """The port's single-process step on the mean of the cluster losses."""
        model = RevGCN(RevGCNConfig(**self.kw))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in self.sd.items()})
        model.train()
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        loss = sum(cross_entropy(model(gt.x, gt), torch.from_numpy(lab), gt.node_mask)
                   for _, gt, lab in self.clusters) / len(self.clusters)
        loss.backward()
        opt.step()
        return float(loss.detach()), {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def check(self, got):
        for g in got:
            np.testing.assert_allclose(g[self.index]["loss"], self.want_loss, rtol=1e-5)
        state = got[0][self.index]["state"]
        for g in got[1:]:
            for k, v in g[self.index]["state"].items():
                np.testing.assert_array_equal(v, state[k], err_msg=k)
        for k, v in state.items():
            if k.endswith("num_batches_tracked"):  # torch's counter: JAX keeps none
                continue
            np.testing.assert_allclose(v, self.want_state[k], err_msg=f"{self.name} {k}", **DP)
        if self.model == "rev":
            loss, seq = self.sequential()
            np.testing.assert_allclose(got[0][self.index]["loss"], loss, rtol=1e-5)
            for k, v in state.items():
                np.testing.assert_allclose(v, seq[k], err_msg=f"sequential {k}", **DP)


NAMES = {2: ["gen halo", "gen halo step", "gcn allgather", "sage halo", "gat halo",
             "dp revgcn", "dp deepergcn batch norm"],
         3: ["gen allgather step", "gcn halo step", "sage allgather step", "gat halo step"]}


def _cases(d):
    if d == 2:
        return [RevCase("gen halo", 2), RevCase("gen halo step", 2, step=True, n=640, seed=1),
                RevCase("gcn allgather", 2, conv="gcn", exchange="allgather", seed=2),
                RevCase("sage halo", 2, conv="sage", seed=3),
                RevCase("gat halo", 2, conv="gat", seed=4),
                DPCase("dp revgcn", 2, "rev"), DPCase("dp deepergcn batch norm", 2, "deeper")]
    return [RevCase("gen allgather step", 3, exchange="allgather", step=True, seed=5,
                    aggr="softmax_sg"),
            RevCase("gcn halo step", 3, conv="gcn", step=True, seed=6),
            RevCase("sage allgather step", 3, conv="sage", exchange="allgather", step=True,
                    seed=7),
            RevCase("gat halo step", 3, conv="gat", step=True, seed=8)]


_RUNS = {}


def _run(d):
    if d not in _RUNS:
        cases = {c.name: c for c in _cases(d)}
        assert list(cases) == NAMES[d]
        for i, c in enumerate(cases.values()):
            c.index = i
        out = launch(tpc.run_cases, d, ([c.port for c in cases.values()],),
                     deadline=torch_budget.SUBPROCESS_S)
        assert all(rk["jax_free"] for rk in out)
        _RUNS[d] = cases, [rk["results"] for rk in out]
    return _RUNS[d]


@pytest.mark.parametrize("d,name", [(d, n) for d in (2, 3) for n in NAMES[d]])
def test_spatial_rev_and_cluster_dp_match_jax(d, name):
    cases, got = _run(d)
    cases[name].check(got)
