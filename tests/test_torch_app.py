"""The port's ogbn-arxiv app, in-process on the CPU at a tiny size."""

import math

import pytest

from deep_gcns_torch_tpu_torch.apps import ogbn_arxiv


def test_app_trains_on_cpu(capsys):
    res = ogbn_arxiv.main(["--synthetic", "--synthetic_nodes", "512", "--num_layers", "3",
                           "--epochs", "2", "--device", "cpu"])
    assert math.isfinite(res["loss"]) and 0.0 <= res["best_valid"] <= 1.0
    assert "epoch 1 loss" in capsys.readouterr().out


def test_app_needs_synthetic():
    with pytest.raises(NotImplementedError):
        ogbn_arxiv.main(["--device", "cpu", "--epochs", "1"])
