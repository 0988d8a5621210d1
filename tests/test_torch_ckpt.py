"""The port's checkpoint path against the JAX package's: save/load round
trips, `load_jax_ckpt` on files the JAX package wrote, the asynchronous
rolling checkpointer, reference-format `.pth` import and export, the apps'
save/resume/score flags and the OGB npz cache, and DeeperGCN's `remat` and
`checkpoint_prologue` (gradients equal with dropout on).

Tolerances: logits against JAX as tests/test_torch_deeper_gcn.py (rtol/atol
1e-4, f32 through a few layers in another summation order) and
tests/test_torch_rev_gat.py (4e-3 / 4e-4 for RevGAT); a checkpoint round
trip, a resumed run and the recomputed layers are exact.
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

from deep_gcns_torch_tpu.data import ogb as jogb
from deep_gcns_torch_tpu.data.synthetic import random_node_graph as jax_random_graph
from deep_gcns_torch_tpu.models import DeeperGCN as JaxDeeperGCN
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu.models.rev_gat import RevGAT as JaxRevGAT
from deep_gcns_torch_tpu.models.rev_gat import RevGATConfig as JaxRevGATConfig
from deep_gcns_torch_tpu.models.rev_gcn import RevGCN as JaxRevGCN
from deep_gcns_torch_tpu.models.rev_gcn import RevGCNConfig as JaxRevGCNConfig
from deep_gcns_torch_tpu.utils import ckpt as jckpt
from deep_gcns_torch_tpu.utils import import_torch as jimport
from deep_gcns_torch_tpu_torch.apps import (ogbn_arxiv, ogbn_arxiv_dgl, ogbn_arxiv_test,
                                            ogbn_proteins_rev, ogbn_proteins_test)
from deep_gcns_torch_tpu_torch.data.ogb import load_ogb_node
from deep_gcns_torch_tpu_torch.data.synthetic import random_node_graph
from deep_gcns_torch_tpu_torch.models import (DeeperGCN, DeeperGCNConfig, RevGAT, RevGATConfig,
                                              RevGCN, RevGCNConfig)
from deep_gcns_torch_tpu_torch.models import deeper_gcn as tdeeper
from deep_gcns_torch_tpu_torch.utils import import_torch as timport
from deep_gcns_torch_tpu_torch.utils.ckpt import (load_ckpt, load_jax_ckpt, save_best,
                                                  save_ckpt)
from deep_gcns_torch_tpu_torch.utils.ckpt_async import AsyncCheckpointer
from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer
from test_torch_rev import _graph as rev_graphs
from test_torch_rev_gat import _graphs as gat_graphs

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
    params, state = jm.init(jax.random.PRNGKey(0))
    _, state = jm.apply(params, state, jnp.asarray(gj.x), gj, train=True)  # running stats
    want, _ = jm.apply(params, state, jnp.asarray(gj.x), gj, train=False)
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
    params, state = jm.init(jax.random.PRNGKey(0))
    want, _ = jm.apply(params, state, jnp.asarray(x), gj, node_feats=jnp.asarray(nf),
                       train=False)
    jckpt.save_ckpt(str(tmp_path / "j"), params=params, state=state, epoch=4)
    return jcfg, (torch.from_numpy(x), gt), {"node_feats": torch.from_numpy(nf)}, want


def _jax_revgat(tmp_path):
    jcfg = JaxRevGATConfig(**REVGAT)
    gt, gj = gat_graphs(np.random.default_rng(4), n=256)
    gt, gj = gt.replace(band=None), gj.replace(band=None)
    jm = JaxRevGAT(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(1))
    want, _ = jm.apply(params, {}, jnp.asarray(gt.x.numpy()), gj, train=False)
    jckpt.save_ckpt(str(tmp_path / "j"), params=params, epoch=4)
    return jcfg, (gt.x, gt), {}, want


@pytest.mark.parametrize("kind,make,tol", [("deeper_gcn", _jax_deeper, TOL),
                                           ("rev_gcn", _jax_revgcn, TOL),
                                           ("rev_gat", _jax_revgat, GAT_TOL)])
def test_load_jax_ckpt_gives_the_jax_logits(tmp_path, kind, make, tol):
    jcfg, args, kw, want = make(tmp_path)
    model = _port_model(kind, 5)
    model.load_state_dict(load_jax_ckpt(str(tmp_path / "j"), kind, jcfg))
    model.eval()
    with torch.no_grad():
        got = model(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_load_jax_ckpt_rejects_an_unknown_kind(tmp_path):
    jcfg, *_ = _jax_revgcn(tmp_path)
    with pytest.raises(ValueError):
        load_jax_ckpt(str(tmp_path / "j"), "gin", jcfg)


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
    params, state = jm.init(jax.random.PRNGKey(2))
    _, state = jm.apply(params, state, jnp.asarray(gj.x), gj, train=True)
    want, _ = jm.apply(params, state, jnp.asarray(gj.x), gj, train=False)
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
    params, state = jm.init(jax.random.PRNGKey(3))
    want, _ = jm.apply(params, state, jnp.asarray(x), gj, node_feats=jnp.asarray(nf),
                       train=False)
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
    params, _ = jm.init(jax.random.PRNGKey(6))
    want, _ = jm.apply(params, {}, jnp.asarray(gt.x.numpy()), gj, train=False)
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


# ---------------------------------------------------------------------------
# the apps: save, resume, score; the OGB cache
# ---------------------------------------------------------------------------

ARXIV = ["--synthetic", "--device", "cpu", "--synthetic_nodes", "400", "--num_layers", "3",
         "--hidden_channels", "16", "--dropout", "0"]


def test_arxiv_resume_equals_uninterrupted_and_test_script_reproduces(tmp_path):
    """The run saves at a new best validation accuracy with that epoch; a
    run resumed from it continues the uninterrupted run's losses exactly
    (dropout 0; the saved state is after that epoch's step, so the resumed
    run's epoch k repeats the uninterrupted run's step k + 1, as in the JAX
    app); the test script gives the accuracies printed at the saved epoch."""
    exp = ["--exp_root", str(tmp_path / "runs")]
    first = ogbn_arxiv.main(ARXIV + exp + ["--epochs", "3", "--save_ckpt"])
    ckpt = first["ckpt"]
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    k = meta["epoch"]
    assert meta["best_value"] == max(v["valid"] for v in first["evals"].values())
    assert os.path.exists(ckpt + "_best.pth")
    resumed = ogbn_arxiv.main(ARXIV + exp + ["--epochs", "6", "--pretrained_model", ckpt])
    assert len(resumed["losses"]) == 6 - k
    whole = ogbn_arxiv.main(ARXIV + ["--epochs", "8"])
    assert resumed["losses"] == whole["losses"][k + 1: k + 1 + len(resumed["losses"])]
    scored = ogbn_arxiv_test.main(ARXIV + ["--pretrained_model", ckpt])
    assert scored["accs"] == first["evals"][k]
    assert scored["meta"]["epoch"] == k
    with pytest.raises(ValueError):
        ogbn_arxiv_test.main(ARXIV)


def test_revgat_teacher_checkpoint_and_student(tmp_path):
    argv = ["--synthetic", "--device", "cpu", "--synthetic_nodes", "512", "--n_layers", "3",
            "--n_hidden", "16", "--epochs", "2", "--exp_root", str(tmp_path / "runs")]
    teacher = ogbn_arxiv_dgl.main(argv + ["--save_ckpt"])
    assert os.path.exists(teacher["ckpt"] + ".pth")
    student = ogbn_arxiv_dgl.main(argv + ["--mode", "student", "--teacher_ckpt",
                                          teacher["ckpt"]])
    assert np.isfinite(student["loss"]) and student["ckpt"] is None
    with pytest.raises(ValueError, match="teacher_ckpt"):
        ogbn_arxiv_dgl.main(argv + ["--mode", "student"])


def test_proteins_async_checkpoints_and_test_script(tmp_path):
    """Rolling checkpoints at each evaluation and `ckpt_best`; the test
    script on a rolling checkpoint, with the training run's evaluation
    partitions (2 views of 2 clusters), gives the app's ROC-AUCs."""
    argv = ["--synthetic", "--device", "cpu", "--num_layers", "2", "--synthetic_nodes", "400",
            "--cluster_number", "2", "--eval_parts", "2", "--num_evals", "2"]
    res = ogbn_proteins_rev.main(argv + ["--epochs", "2", "--eval_every", "1", "--save_ckpt",
                                         "--exp_root", str(tmp_path / "runs")])
    exp = res["exp"]
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["0", "1"]
    with open(os.path.join(exp, "ckpt_best.json")) as f:
        assert json.load(f)["best_value"] == res["best_valid"]
    out = ogbn_proteins_test.main(argv + ["--pretrained_model",
                                          os.path.join(exp, "ckpt", "1", "ckpt")])
    assert out["meta"]["epoch"] == 1 and out["peak_bytes"] is None
    for split, v in res["results"].items():  # the training run's last evaluation
        assert out["aucs"][split] == pytest.approx(v, abs=1e-12)


def _write_npz_caches(root, rng):
    n, e = 300, 2400
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    perm = rng.permutation(n)
    split = dict(split_train=perm[:180], split_valid=perm[180:240], split_test=perm[240:])
    np.savez(os.path.join(root, "ogbn_arxiv.npz"),
             x=rng.standard_normal((n, 16)).astype(np.float32),
             labels=rng.integers(0, 5, (n, 1)), senders=s, receivers=r, num_tasks=1, **split)
    np.savez(os.path.join(root, "ogbn_proteins.npz"),
             x=np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)],
             labels=(rng.random((n, 4)) < 0.4).astype(np.int64), senders=s, receivers=r,
             edge_attr=rng.random((e, 8)).astype(np.float32), num_tasks=4, **split)


def test_ogb_npz_cache_matches_jax_and_apps_train_on_it(tmp_path):
    _write_npz_caches(str(tmp_path), np.random.default_rng(0))
    for name in ("ogbn-arxiv", "ogbn-proteins"):
        got, want = load_ogb_node(name, str(tmp_path)), jogb.load_ogb_node(name, str(tmp_path))
        assert got.name == want.name and got.num_tasks == want.num_tasks
        for field in ("x", "labels", "senders", "receivers", "edge_attr"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None and b is None) or np.array_equal(a, b), field
        for k in ("train", "valid", "test"):
            np.testing.assert_array_equal(got.splits[k], want.splits[k])
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        load_ogb_node("ogbn-arxiv", str(tmp_path / "none"))
    root = ["--device", "cpu", "--data_root", str(tmp_path)]
    res = ogbn_arxiv.main(root + ["--num_layers", "2", "--hidden_channels", "8",
                                  "--num_classes", "5", "--epochs", "2"])
    assert np.isfinite(res["loss"]) and 0.0 <= res["best_valid"] <= 1.0
    res = ogbn_proteins_rev.main(root + ["--num_layers", "2", "--num_tasks", "4", "--epochs", "1",
                                         "--cluster_number", "2", "--eval_parts", "2"])
    assert np.isfinite(res["loss"]) and set(res["results"]) == {"train", "valid", "test"}


# ---------------------------------------------------------------------------
# remat and checkpoint_prologue
# ---------------------------------------------------------------------------

def _remat_run(block, **knobs):
    g, _ = random_node_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    co = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (g.num_nodes_padded, 7)).astype(np.float32))
    model = DeeperGCN(DeeperGCNConfig(**dict(DEEPER, block=block, dropout=0.3, **knobs)),
                      generator=torch.Generator().manual_seed(0))
    model.train()
    gen = torch.Generator().manual_seed(5)
    out = model(g.x, g, gen)
    (out * co).sum().backward()
    return (out.detach(), {k: p.grad for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()}, gen.get_state())


@pytest.mark.parametrize("block", ["res+", "res"])
@pytest.mark.parametrize("knobs", [dict(remat=True), dict(checkpoint_prologue=True),
                                   dict(remat=True, checkpoint_prologue=True)])
def test_remat_equals_plain_with_dropout(block, knobs):
    """Logits, every gradient, the running statistics (updated once: the
    recompute leaves them alone) and the generator's final state equal the
    plain model's, with dropout 0.3 from one generator."""
    plain = _remat_run(block)
    got = _remat_run(block, **knobs)
    assert torch.equal(got[0], plain[0])
    for k, want in plain[1].items():
        assert torch.equal(got[1][k], want), k
    for k, want in plain[2].items():
        assert torch.equal(got[2][k], want), k
    assert all(int(v) == 1 for k, v in got[2].items() if k.endswith("num_batches_tracked"))
    assert torch.equal(got[3], plain[3])


def test_remat_without_generator_replay_draws_other_masks(monkeypatch):
    """The check above has teeth: a plain `torch.utils.checkpoint`, which
    restores only the global RNGs, recomputes with the generator's next
    masks, and the gradients come out wrong."""
    plain = _remat_run("res+")
    monkeypatch.setattr(tdeeper, "checkpoint_replay", lambda fn, gen, *a: (
        torch.utils.checkpoint.checkpoint(fn, *a, use_reentrant=False)))
    naive = _remat_run("res+", remat=True)
    assert torch.equal(naive[0], plain[0])
    assert not all(torch.allclose(naive[1][k], v) for k, v in plain[1].items())


def test_remat_eval_and_defaults():
    g, _ = random_node_graph(np.random.default_rng(0), 300, 6, 16, self_loops=True)
    a = DeeperGCN(DeeperGCNConfig(**DEEPER), generator=torch.Generator().manual_seed(0)).eval()
    b = DeeperGCN(DeeperGCNConfig(**dict(DEEPER, remat=True, checkpoint_prologue=True)),
                  generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        assert torch.equal(a(g.x, g), b(g.x, g))
    # the port's default differs from JAX's (True) by design
    assert DeeperGCNConfig(**DEEPER).checkpoint_prologue is False
    assert JaxConfig(**DEEPER).checkpoint_prologue is True
