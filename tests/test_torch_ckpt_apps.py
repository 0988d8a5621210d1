"""The apps' checkpoint flags and DeeperGCN's recomputation: save/resume/
score runs of the arxiv, RevGAT and proteins apps, the OGB npz cache against
the JAX package's loader with the apps training on it, and DeeperGCN's
`remat` and `checkpoint_prologue` (gradients equal with dropout on). Kept
apart from tests/test_torch_ckpt.py so that the two files run on two test
workers.

A resumed run, a rescored checkpoint and the recomputed layers are exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.data import ogb as jogb
from deep_gcns_torch_tpu.models import DeeperGCNConfig as JaxConfig
from deep_gcns_torch_tpu_torch.apps import (ogbn_arxiv, ogbn_arxiv_dgl, ogbn_arxiv_test,
                                            ogbn_proteins_rev, ogbn_proteins_test)
from deep_gcns_torch_tpu_torch.data.ogb import load_ogb_node
from deep_gcns_torch_tpu_torch.data.synthetic import random_node_graph
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig
from deep_gcns_torch_tpu_torch.models import deeper_gcn as tdeeper
from test_torch_ckpt import DEEPER
from torch_budget import budget  # noqa: F401


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
