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


@pytest.mark.parametrize("reorder", ["cluster", "rcm"])
def test_app_band_route_on_cpu(capsys, monkeypatch, reorder):
    """--reorder/--band rebuild the synthetic graph through the reorder and
    band pipeline, and GENConv then takes the band route."""
    import deep_gcns_torch_tpu_torch.convs.sparse as convs

    calls = []
    real = convs.band_softmax_agg_auto
    monkeypatch.setattr(convs, "band_softmax_agg_auto",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    res = ogbn_arxiv.main(["--synthetic", "--synthetic_nodes", "512", "--num_layers", "3",
                           "--epochs", "2", "--device", "cpu", "--reorder", reorder,
                           "--band", "auto"])
    out = capsys.readouterr().out
    assert math.isfinite(res["loss"]) and 0.0 <= res["best_valid"] <= 1.0
    assert "band attached: window=" in out and "epoch 1 loss" in out
    # 2 train steps and 2 predicts of 3 layers, all on the band route
    assert len(calls) == 12
