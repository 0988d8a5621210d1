"""The apps' ``--spatial 2`` on tiny synthetic data, two gloo ranks each:
ogbn-arxiv with ``--save_ckpt`` (its checkpoint carries the single-process
`DeeperGCN`'s `state_dict` names, and `apps/ogbn_arxiv_test` reproduces the
run's best validation accuracy from it), ogbn-proteins (DyResGEN and
RevGCN) and ogbn-products, each reaching its end with finite losses;
ogbn-arxiv with ``--tp 2`` (a 1 × 2 grid) and ``--spatial 2 --tp 2`` (2 × 2)
and ``--save_ckpt``, whose checkpoint `apps/ogbn_arxiv_test` scores in one
process to the run's printed best exactly; and ``--tp`` > 1 refused by the
apps that do not train with it (products and both proteins apps)."""

import math

import pytest
import torch

from deep_gcns_torch_tpu_torch.apps import (ogbn_arxiv, ogbn_arxiv_test, ogbn_products,
                                            ogbn_proteins, ogbn_proteins_rev)
from torch_budget import budget  # noqa: F401

ARXIV = ["--synthetic", "--device", "cpu", "--synthetic_nodes", "600", "--num_layers", "2",
         "--hidden_channels", "16"]
PROTEINS = ["--synthetic", "--device", "cpu", "--synthetic_nodes", "600", "--num_layers", "3",
            "--synthetic_degree", "8", "--epochs", "2", "--spatial", "2"]


def _finite(out):
    assert out["losses"] and all(math.isfinite(v) for v in out["losses"])
    assert 0.0 <= out["best_valid"] <= 1.0


def test_arxiv_spatial_checkpoint_scores_in_the_single_process_model(tmp_path):
    out = ogbn_arxiv.main(ARXIV + ["--epochs", "3", "--spatial", "2", "--exchange", "halo",
                                   "--save_ckpt", "--exp_root", str(tmp_path)])
    _finite(out)
    assert sorted(out["evals"]) == [0, 2]
    names = set(torch.load(out["ckpt"] + ".pth", weights_only=False)["model_state_dict"])
    single = ogbn_arxiv.build_model(ogbn_arxiv.get_args(ARXIV), 128)
    assert names == set(single.state_dict())
    best = max(out["evals"], key=lambda e: out["evals"][e]["valid"])
    for spatial in ([], ["--spatial", "2"]):  # one process, and the run's two ranks
        te = ogbn_arxiv_test.main(ARXIV + spatial + ["--pretrained_model", out["ckpt"]])
        assert te["accs"]["valid"] == out["best_valid"] == te["meta"]["best_value"]
        assert te["accs"] == out["evals"][best]


@pytest.mark.parametrize("app,extra", [(ogbn_proteins_rev, []),
                                       (ogbn_proteins, ["--hidden_channels", "16",
                                                        "--learn_t", "--exchange",
                                                        "allgather"])])
def test_proteins_spatial_reaches_its_end(app, extra):
    out = app.main(PROTEINS + extra)
    _finite(out)
    assert set(out["results"]) == {"train", "valid", "test"}


def test_products_spatial_reaches_its_end():
    _finite(ogbn_products.main(["--synthetic", "--device", "cpu", "--synthetic_nodes", "1500",
                                "--num_layers", "2", "--hidden_channels", "16",
                                "--epochs", "2", "--spatial", "2"]))


@pytest.mark.parametrize("grid", [["--tp", "2"], ["--spatial", "2", "--tp", "2"]],
                         ids=["1x2", "2x2"])
def test_arxiv_tensor_parallel_checkpoint_scores_in_one_process(tmp_path, grid):
    out = ogbn_arxiv.main(ARXIV + grid + ["--epochs", "3", "--save_ckpt",
                                          "--exp_root", str(tmp_path)])
    _finite(out)
    assert sorted(out["evals"]) == [0, 2] and out["collective_calls"] > 0
    names = set(torch.load(out["ckpt"] + ".pth", weights_only=False)["model_state_dict"])
    assert names == set(ogbn_arxiv.build_model(ogbn_arxiv.get_args(ARXIV), 128).state_dict())
    best = max(out["evals"], key=lambda e: out["evals"][e]["valid"])
    te = ogbn_arxiv_test.main(ARXIV + grid + ["--pretrained_model", out["ckpt"]])
    assert te["accs"]["valid"] == out["best_valid"] == te["meta"]["best_value"]
    assert te["accs"] == out["evals"][best]


@pytest.mark.parametrize("app", [ogbn_products, ogbn_proteins, ogbn_proteins_rev])
def test_tensor_parallel_flag_raises(app):
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        app.main(["--synthetic", "--device", "cpu", "--synthetic_nodes", "300", "--tp", "2"])
