"""The port's checkpoint path against the JAX package's: save/load round
trips, `load_jax_ckpt` on files the JAX package wrote, the asynchronous
rolling checkpointer, and reference-format `.pth` import and export. The
apps' save/resume/score flags, the OGB npz cache and DeeperGCN's `remat` are
in tests/test_torch_ckpt_apps.py.

Tolerances: logits against JAX as tests/test_torch_deeper_gcn.py (rtol/atol
1e-4, f32 through a few layers in another summation order) and
tests/test_torch_rev_gat.py (4e-3 / 4e-4 for RevGAT); a checkpoint round
trip is exact.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_gcns_torch_tpu.data.synthetic import random_node_graph as jax_random_graph
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu.models.rev_gat import RevGAT as JaxRevGAT
from deep_gcns_torch_tpu.models.rev_gat import RevGATConfig as JaxRevGATConfig
from deep_gcns_torch_tpu.models.rev_gcn import RevGCN as JaxRevGCN
from deep_gcns_torch_tpu.models.rev_gcn import RevGCNConfig as JaxRevGCNConfig
from deep_gcns_torch_tpu.utils import ckpt as jckpt
from deep_gcns_torch_tpu.utils import import_torch as jimport
from deep_gcns_torch_tpu_torch.data.synthetic import random_node_graph
from deep_gcns_torch_tpu_torch.models import (DeeperGCN, DeeperGCNConfig, RevGAT, RevGATConfig,
                                              RevGCN, RevGCNConfig)
from deep_gcns_torch_tpu_torch.utils import import_torch as timport
from deep_gcns_torch_tpu_torch.utils.ckpt import (load_ckpt, load_jax_ckpt, save_best,
                                                  save_ckpt)
from deep_gcns_torch_tpu_torch.utils.ckpt_async import AsyncCheckpointer
from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer
from test_torch_rev import _graph as rev_graphs
from test_torch_rev_gat import _graphs as gat_graphs
from torch_budget import budget  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
GAT_TOL = dict(rtol=4e-3, atol=4e-4)

DEEPER = dict(in_channels=16, hidden_channels=32, num_tasks=7, num_layers=3, block="res+",
              aggr="softmax", t=0.5, learn_t=True, norm="batch", mlp_layers=2, dropout=0.0)
REVGCN = dict(in_channels=8, node_feat_dim=8, edge_feat_dim=8, hidden_channels=16, num_tasks=7,
              num_layers=3, group=2, aggr="softmax", t=0.7, learn_t=True, dropout=0.0,
              use_one_hot_encoding=True)
REVGAT = dict(in_feats=32, n_classes=8, n_layers=4, n_hidden=12, n_heads=2, group=2,
              dropout=0.0, input_drop=0.0, edge_drop=0.0)


def _jax_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _apply(jm, params, state, x, g, **kw):
    """JAX's `jm.apply` on ``x`` as one compiled program, the graph and the
    keywords held fixed."""
    return jax.jit(lambda p, s, x_: jm.apply(p, s, x_, g, **kw))(params, state, jnp.asarray(x))


def _port_model(kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if kind == "deeper_gcn":
        return DeeperGCN(DeeperGCNConfig(**DEEPER), generator=gen)
    if kind == "rev_gcn":
        return RevGCN(RevGCNConfig(**REVGCN), generator=gen)
    return RevGAT(RevGATConfig(**REVGAT), generator=gen)


def _assert_state_equal(a, b):
    """Nested state dicts (tensors, dicts, lists, scalars) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_state_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_state_equal(x, y)
    else:
        assert a == b


def _train_state(model, opt, seed):
    """Random gradients through one optimizer step, and random buffers, so
    that every tensor of a checkpoint carries information."""
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    with torch.no_grad():
        for b in model.buffers():
            if b.is_floating_point():
                b.copy_(torch.rand(b.shape, generator=g))


# ---------------------------------------------------------------------------
# save / load round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["deeper_gcn", "rev_gcn", "rev_gat"])
def test_save_load_round_trip(tmp_path, kind):
    model = _port_model(kind, 0)
    opt = make_optimizer("adam", model.parameters(), 1e-2)
    _train_state(model, opt, 1)
    path = str(tmp_path / "run" / "ckpt")
    save_ckpt(path, model=model, optimizer=opt, epoch=3, best_value=0.5, extra={"lr": 0.01})
    save_best(path, True)
    save_best(path + "_none", False)
    assert not os.path.exists(path + "_none_best.pth")
    with open(path + ".json") as f:
        assert json.load(f) == {"epoch": 3, "best_value": 0.5, "lr": 0.01}
    for prefix in (path, path + "_best"):
        other = _port_model(kind, 7)
        other_opt = make_optimizer("adam", other.parameters(), 1e-2)
        meta = load_ckpt(prefix, model=other, optimizer=other_opt)
        assert meta == {"epoch": 3, "best_value": 0.5, "lr": 0.01}
        _assert_state_equal(model.state_dict(), other.state_dict())
        _assert_state_equal(opt.state_dict(), other_opt.state_dict())
    # the reference's own format: a plain torch.load gives its keys
    raw = torch.load(path + ".pth", weights_only=False)
    assert {"epoch", "model_state_dict", "optimizer_state_dict", "best_value"} <= set(raw)
    assert all(v.device.type == "cpu" for v in raw["model_state_dict"].values())


def test_load_ckpt_without_optimizer_state_raises(tmp_path):
    model = _port_model("deeper_gcn")
    save_ckpt(str(tmp_path / "c"), model=model)
    load_ckpt(str(tmp_path / "c"), model=_port_model("deeper_gcn", 3))
    with pytest.raises(KeyError):
        load_ckpt(str(tmp_path / "c"), model=model,
                  optimizer=make_optimizer("adam", model.parameters(), 1e-2))


# ---------------------------------------------------------------------------
# the JAX package's checkpoints
# ---------------------------------------------------------------------------

def _jax_deeper(tmp_path):
    jcfg = JaxConfig(**DEEPER)
    gj, _ = jax_random_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    gt, _ = random_node_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    jm = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    _, state = _apply(jm, params, state, gj.x, gj, train=True)  # running stats
    want, _ = _apply(jm, params, state, gj.x, gj, train=False)
    jckpt.save_ckpt(str(tmp_path / "j"), params=params, state=state,
                    opt_state=optax.adam(1e-2).init(params), epoch=4, best_value=0.3)
    return jcfg, (gt.x, gt), {}, want


def _jax_revgcn(tmp_path):
    jcfg = JaxRevGCNConfig(**REVGCN)
    gt, gj = rev_graphs(7, n=80, e=400, edge_dim=8)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((gt.num_nodes_padded, 8)).astype(np.float32)
    nf = rng.standard_normal((gt.num_nodes_padded, 8)).astype(np.float32)
    jm = JaxRevGCN(jcfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(0))
    want, _ = _apply(jm, params, state, x, gj, node_feats=jnp.asarray(nf), train=False)
    jckpt.save_ckpt(str(tmp_path / "j"), params=params, state=state, epoch=4)
    return jcfg, (torch.from_numpy(x), gt), {"node_feats": torch.from_numpy(nf)}, want


def _jax_revgat(tmp_path):
    jcfg = JaxRevGATConfig(**REVGAT)
    gt, gj = gat_graphs(np.random.default_rng(4), n=256)
    gt, gj = gt.replace(band=None), gj.replace(band=None)
    jm = JaxRevGAT(jcfg)
    params, _ = jax.jit(jm.init)(jax.random.PRNGKey(1))
    want, _ = _apply(jm, params, {}, gt.x.numpy(), gj, train=False)
    jckpt.save_ckpt(str(tmp_path / "j"), params=params, epoch=4)
    return jcfg, (gt.x, gt), {}, want


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """Each `_jax_*` above run once for the module, in a directory of its
    own: ``jax_ckpt(make)`` gives (that directory, what ``make`` returned)."""
    made = {}

    def get(make):
        if make not in made:
            root = tmp_path_factory.mktemp(make.__name__)
            made[make] = root, make(root)
        return made[make]
    return get


@pytest.mark.parametrize("kind,make,tol", [("deeper_gcn", _jax_deeper, TOL),
                                           ("rev_gcn", _jax_revgcn, TOL),
                                           ("rev_gat", _jax_revgat, GAT_TOL)])
def test_load_jax_ckpt_gives_the_jax_logits(jax_ckpt, kind, make, tol):
    root, (jcfg, args, kw, want) = jax_ckpt(make)
    model = _port_model(kind, 5)
    model.load_state_dict(load_jax_ckpt(str(root / "j"), kind, jcfg))
    model.eval()
    with torch.no_grad():
        got = model(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_load_jax_ckpt_rejects_an_unknown_kind(jax_ckpt):
    root, (jcfg, *_) = jax_ckpt(_jax_revgcn)
    with pytest.raises(ValueError):
        load_jax_ckpt(str(root / "j"), "gin", jcfg)


# ---------------------------------------------------------------------------
# the asynchronous checkpointer
# ---------------------------------------------------------------------------

def test_async_checkpointer_keeps_latest_and_pins_best(tmp_path):
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    saved = {}
    for step, valid in enumerate([0.1, 0.9, 0.3, 0.2, 0.4]):
        for p in model.parameters():
            p.grad = torch.full_like(p, float(step + 1))
        opt.step()
        saved[step] = copy.deepcopy((model.state_dict(), opt.state_dict()))
        ck.save(step, model=model, optimizer=opt, metrics={"valid": valid},
                meta={"epoch": step})
        with torch.no_grad():  # the snapshot is taken at save(): later updates miss it
            model.weight.add_(100.0)
        model.load_state_dict(saved[step][0])
    ck.wait()
    assert ck.latest_step() == 4 and ck.best_step() == 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "3", "4"]
    for step in (None, 1):
        m2 = torch.nn.Linear(4, 3)
        o2 = torch.optim.SGD(m2.parameters(), lr=0.1, momentum=0.9)
        meta = ck.restore(step, model=m2, optimizer=o2)
        want = 4 if step is None else 1
        assert meta["epoch"] == want and meta["step"] == want
        _assert_state_equal(saved[want][0], m2.state_dict())
        _assert_state_equal(saved[want][1], o2.state_dict())
    ck.close()
    # a new checkpointer on the directory sees the kept steps
    again = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=1)
    assert again.latest_step() == 4 and again.best_step() == 1
    again.save(5, model=model, metrics={"valid": 0.0})
    again.close()
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "5"]


def test_async_checkpointer_best_mode_min_and_no_metrics(tmp_path):
    model = torch.nn.Linear(2, 2)
    ck = AsyncCheckpointer(str(tmp_path / "ck"), max_to_keep=1, best_mode="min")
    ck.save(0, model=model, metrics={"valid": 0.5})
    ck.save(1, model=model, metrics={"valid": 0.7})
    ck.save(2, model=model)  # no metrics: ranks below every step with one
    ck.wait()
    assert ck.best_step() == 0 and ck.latest_step() == 2
    assert sorted(os.listdir(tmp_path / "ck")) == ["0", "2"]
    ck.close()
    with pytest.raises(FileNotFoundError):
        AsyncCheckpointer(str(tmp_path / "empty")).restore(model=model)
    with pytest.raises(ValueError):
        AsyncCheckpointer(str(tmp_path / "x"), best_mode="median")


# ---------------------------------------------------------------------------
# reference-format .pth import and export
# ---------------------------------------------------------------------------

def _write_reference(path, sd):
    torch.save({"epoch": 7, "model_state_dict": {"module." + k: torch.from_numpy(np.array(v))
                                                 for k, v in sd.items()},
                "optimizer_state_dict": {}}, path)


@pytest.mark.parametrize("learn_t", [True, False])
def test_reference_deepergcn_pth_loads_and_exports(tmp_path, learn_t):
    """A reference checkpoint built by JAX's `export_deepergcn` (with its
    fixed t written out when not learned) gives JAX's logits."""
    cfg = dict(DEEPER, learn_t=learn_t)
    jcfg = JaxConfig(**cfg)
    gj, _ = jax_random_graph(np.random.default_rng(1), 200, 6, 16, self_loops=True)
    gt, _ = random_node_graph(np.random.default_rng(1), 200, 6, 16, self_loops=True)
    jm = JaxDeeperGCN(jcfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(2))
    _, state = _apply(jm, params, state, gj.x, gj, train=True)
    want, _ = _apply(jm, params, state, gj.x, gj, train=False)
    sd = jimport.export_deepergcn(params, state, jcfg)
    _write_reference(str(tmp_path / "ref.pth"), sd)
    model = DeeperGCN(DeeperGCNConfig(**cfg))
    timport.import_deepergcn(timport.load_reference_checkpoint(str(tmp_path / "ref.pth")),
                             model)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(gt.x, gt).numpy(), np.asarray(want), **TOL)
    out = timport.export_deepergcn(model)
    want_keys = {k for k in sd if learn_t or not k.endswith(".t")}
    assert set(out) == want_keys
    for k in want_keys:
        np.testing.assert_array_equal(out[k], np.asarray(sd[k]), err_msg=k)
    # the proteins naming, and a fixed t that the model does not have
    timport.import_deepergcn({k.replace("norms.", "layer_norms.", 1) if k.startswith("norms.")
                              else k: v for k, v in sd.items()}, model)
    if not learn_t:
        bad = dict(sd, **{"gcns.0.t": np.asarray([0.9], np.float32)})
        with pytest.raises(ValueError, match="fixed"):
            timport.import_deepergcn(bad, model)


def test_reference_revgcn_pth_loads_and_exports(tmp_path):
    jcfg = JaxRevGCNConfig(**REVGCN)
    gt, gj = rev_graphs(3, n=80, e=400, edge_dim=8)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((gt.num_nodes_padded, 8)).astype(np.float32)
    nf = rng.standard_normal((gt.num_nodes_padded, 8)).astype(np.float32)
    jm = JaxRevGCN(jcfg)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(3))
    want, _ = _apply(jm, params, state, x, gj, node_feats=jnp.asarray(nf), train=False)
    sd = jimport.export_revgcn(params, state, jcfg)
    assert any("._fn.Fms." in k for k in sd)
    _write_reference(str(tmp_path / "ref.pth"), sd)
    model = RevGCN(RevGCNConfig(**REVGCN))
    timport.import_revgcn(timport.load_reference_checkpoint(str(tmp_path / "ref.pth")), model)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), gt, node_feats=torch.from_numpy(nf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    out = timport.export_revgcn(model)
    assert set(out) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(out[k], np.asarray(sd[k]), err_msg=k)
    with pytest.raises(ValueError, match="unmapped"):
        timport.import_revgcn(dict(sd, extra_weight=np.zeros(3, np.float32)), model)


def test_reference_revgat_pth_loads_and_exports(tmp_path):
    jcfg = JaxRevGATConfig(**REVGAT)
    gt, gj = gat_graphs(np.random.default_rng(5), n=256)
    gt, gj = gt.replace(band=None), gj.replace(band=None)
    jm = JaxRevGAT(jcfg)
    params, _ = jax.jit(jm.init)(jax.random.PRNGKey(6))
    want, _ = _apply(jm, params, {}, gt.x.numpy(), gj, train=False)
    sd = jimport.export_revgat(params, jcfg)
    _write_reference(str(tmp_path / "ref.pth"), sd)
    model = RevGAT(RevGATConfig(**REVGAT))
    timport.import_revgat(timport.load_reference_checkpoint(str(tmp_path / "ref.pth")), model)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(gt.x, gt).numpy(), np.asarray(want), **GAT_TOL)
    out = timport.export_revgat(model)
    assert set(out) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(out[k], np.asarray(sd[k]), err_msg=k)
    missing = {k: v for k, v in sd.items() if k != "bias_last.bias"}
    with pytest.raises(ValueError, match="missing"):
        timport.import_revgat(missing, model)
    timport.import_revgat(missing, model, strict=False)
