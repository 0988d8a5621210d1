"""The port's four OGB apps of DeeperGCN (ogbg-mol, ogbg-ppa, ogbl-collab,
ogbn-products) and their test scripts on synthetic data on the CPU, tiny:
each builds the JAX app's data from the seed, trains, writes `ckpt_best`
with ``--save_ckpt``, and its test script reproduces the best score the
training run printed. Also the ``--optimizer`` / ``--weight_decay`` flags of
the arxiv and proteins apps."""

import argparse
import importlib.util
import math
import os

import numpy as np
import pytest

from deep_gcns_torch_tpu_torch.apps import (ogbg_mol, ogbg_mol_test, ogbg_ppa, ogbg_ppa_test,
                                            ogbl_collab, ogbl_collab_test, ogbn_arxiv,
                                            ogbn_products, ogbn_products_test, ogbn_proteins)
from torch_budget import budget  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--synthetic", "--device", "cpu"]


def _jax_app(name):
    """`examples/<name>/main.py` of the JAX package, imported by path (its
    data functions import numpy and the JAX package's constants only)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", name, "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal_graph_lists(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert set(ga) == set(gb)
        for k in ga:
            np.testing.assert_array_equal(np.asarray(ga[k]), np.asarray(gb[k]), err_msg=k)


@pytest.mark.parametrize("num_tasks", [1, 6])
def test_mol_data_matches_jax(num_tasks):
    jax_app = _jax_app("ogbg_mol")
    args = argparse.Namespace(synthetic=True, num_tasks=num_tasks)
    want = jax_app.load_mol(args, np.random.default_rng(3))
    got = ogbg_mol.load_mol(args, np.random.default_rng(3))
    for w, g in zip(want, got):
        _equal_graph_lists(w, g)
    assert np.isnan(np.stack([g["y"] for g in got[0]])).any() == (num_tasks > 1)


def test_ppa_data_matches_jax():
    args = argparse.Namespace(synthetic=True, num_classes=37)
    want = _jax_app("ogbg_ppa").load_ppa(args, np.random.default_rng(4))
    for w, g in zip(want, ogbg_ppa.load_ppa(args, np.random.default_rng(4))):
        _equal_graph_lists(w, g)


def test_collab_and_products_data_match_jax():
    args = argparse.Namespace(synthetic=True, synthetic_nodes=500, num_classes=47)
    g_j, tr_j, va_j, n_j, d_j = _jax_app("ogbl_collab").load_data(args, np.random.default_rng(5))
    g_t, tr_t, va_t, n_t, d_t = ogbl_collab.load_data(args, np.random.default_rng(5))
    assert (n_j, d_j) == (n_t, d_t)
    np.testing.assert_array_equal(np.asarray(g_j.x), g_t.x.numpy())
    for a, b in zip(tr_j + va_j, tr_t + va_t):
        np.testing.assert_array_equal(a, b)
    want = _jax_app("ogbn_products").load_data(args, np.random.default_rng(6))
    got = ogbn_products.load_data(args, np.random.default_rng(6))
    for a, b in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in want[4]:
        np.testing.assert_array_equal(want[4][k], got[4][k])
    assert want[5:] == got[5:]


def _ckpt(res):
    path = os.path.join(res["exp"], "ckpt_best")
    assert os.path.exists(path + ".pth") and os.path.exists(path + ".json")
    return path


MOL = CPU + ["--num_layers", "2", "--hidden_channels", "16", "--batch_size", "8", "--learn_t"]
PPA = CPU + ["--num_layers", "2", "--hidden_channels", "16", "--batch_size", "8"]
COLLAB = CPU + ["--synthetic_nodes", "400", "--hidden_channels", "16", "--batch_edges", "256"]
PRODUCTS = CPU + ["--synthetic_nodes", "1500", "--num_layers", "2", "--hidden_channels", "16",
                  "--eval_every", "1"]


def test_mol_app_and_test_script(tmp_path, capsys):
    res = ogbg_mol.main(MOL + ["--epochs", "2", "--save_ckpt", "--exp_root", str(tmp_path)])
    assert len(res["losses"]) == 2 and all(math.isfinite(v) for v in res["losses"])
    assert res["best"] == max(res["scores"])
    scored = ogbg_mol_test.main(MOL + ["--pretrained_model", _ckpt(res)])
    assert scored["score"] == res["best"]
    assert f"test ROC-AUC: {res['best']:.4f}" in capsys.readouterr().out


def test_mol_app_virtual_node_many_tasks(tmp_path):
    """ResGEN with the virtual node on NaN-masked multi-task labels, the
    value clip and the "adamw" optimizer with decay; the test script
    reports average precision."""
    argv = CPU + ["--num_layers", "3", "--hidden_channels", "16", "--batch_size", "8",
                  "--add_virtual_node", "--num_tasks", "6", "--grad_clip", "0.1",
                  "--optimizer", "adamw", "--weight_decay", "0.01"]
    res = ogbg_mol.main(argv + ["--epochs", "2", "--save_ckpt", "--exp_root", str(tmp_path)])
    assert all(math.isfinite(v) for v in res["losses"])
    assert ogbg_mol_test.main(argv + ["--pretrained_model", _ckpt(res)])["score"] == res["best"]


def test_ppa_app_and_test_script(tmp_path):
    res = ogbg_ppa.main(PPA + ["--epochs", "2", "--save_ckpt", "--exp_root", str(tmp_path)])
    assert all(math.isfinite(v) for v in res["losses"])
    assert ogbg_ppa_test.main(PPA + ["--pretrained_model", _ckpt(res)])["acc"] == res["best"]


def test_collab_app_and_test_script(tmp_path):
    res = ogbl_collab.main(COLLAB + ["--epochs", "6", "--save_ckpt", "--exp_root",
                                     str(tmp_path)])
    assert sorted(res["evals"]) == [0, 5] and len(res["losses"]) == 6
    assert all(math.isfinite(v) for v in res["losses"])
    scored = ogbl_collab_test.main(COLLAB + ["--pretrained_model", _ckpt(res)])
    assert scored["hits"] == res["best"]


def test_products_app_and_test_script(tmp_path):
    res = ogbn_products.main(PRODUCTS + ["--epochs", "2", "--save_ckpt", "--exp_root",
                                         str(tmp_path)])
    assert sorted(res["evals"]) == [0, 1] and len(res["partition_s"]) == 2
    best_epoch = max(res["evals"], key=lambda e: res["evals"][e]["valid"])
    scored = ogbn_products_test.main(PRODUCTS + ["--pretrained_model", _ckpt(res)])
    assert scored["accs"] == res["evals"][best_epoch]
    assert scored["meta"]["epoch"] == best_epoch


def test_apps_without_ckpt_write_nothing(tmp_path):
    ogbg_ppa.main(PPA + ["--epochs", "1", "--exp_root", str(tmp_path)])
    assert os.listdir(tmp_path) == []
    with pytest.raises(NotImplementedError):  # tensor parallelism
        ogbn_products.main(PRODUCTS + ["--epochs", "1", "--tp", "2"])
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        ogbg_mol.main(["--device", "cpu", "--epochs", "1"])


@pytest.mark.parametrize("optimizer", ["adamw", "radam"])
def test_arxiv_and_proteins_apps_take_optimizer_flags(optimizer):
    flags = ["--optimizer", optimizer, "--weight_decay", "0.01"]
    res = ogbn_arxiv.main(CPU + ["--synthetic_nodes", "400", "--num_layers", "2",
                                 "--hidden_channels", "16", "--epochs", "2"] + flags)
    assert all(math.isfinite(v) for v in res["losses"])
    res = ogbn_proteins.main(CPU + ["--synthetic_nodes", "400", "--num_layers", "2",
                                    "--epochs", "1"] + flags)
    assert math.isfinite(res["loss"])
