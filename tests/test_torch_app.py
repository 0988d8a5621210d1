"""The port's ogbn-arxiv app, in-process on the CPU at a tiny size."""

import math

import pytest

from deep_gcns_torch_tpu_torch.apps import ogbn_arxiv, ogbn_arxiv_dgl
from torch_budget import budget  # noqa: F401


def test_app_trains_on_cpu(capsys):
    res = ogbn_arxiv.main(["--synthetic", "--synthetic_nodes", "512", "--num_layers", "3",
                           "--epochs", "2", "--device", "cpu"])
    assert math.isfinite(res["loss"]) and 0.0 <= res["best_valid"] <= 1.0
    assert "epoch 1 loss" in capsys.readouterr().out


def test_app_needs_synthetic(tmp_path):
    """Without --synthetic the app reads the OGB cache; with none there it
    raises the JAX loader's FileNotFoundError (there is no download)."""
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        ogbn_arxiv.main(["--device", "cpu", "--epochs", "1", "--data_root", str(tmp_path)])


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


@pytest.mark.parametrize("band", [False, True])
def test_revgat_app_trains_on_cpu(capsys, monkeypatch, band):
    """apps/ogbn_arxiv_dgl at a tiny size: label reuse, RMSprop with its
    warm-up, the refinement in `predict`; the CSC route (K5/K6's plain
    versions) on the plain graph, the band route after --reorder/--band."""
    import deep_gcns_torch_tpu_torch.convs.dgl_gat as tconv

    calls = []
    name = "band_gat_agg" if band else "gat_softmax_spmm"
    real = getattr(tconv, name)
    monkeypatch.setattr(tconv, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    argv = ["--synthetic", "--synthetic_nodes", "384", "--epochs", "2", "--device", "cpu",
            "--n_layers", "3", "--n_hidden", "8", "--n_heads", "2"]
    if band:
        argv += ["--reorder", "cluster", "--band", "auto", "--compute_dtype", "bfloat16"]
    res = ogbn_arxiv_dgl.main(argv)
    assert math.isfinite(res["loss"]) and 0.0 <= res["best_valid"] <= 1.0
    assert "epoch 1 loss" in capsys.readouterr().out
    # 2 steps of 2 + 2 group convs (the backward re-runs the middle groups
    # once more) and 2 predicts of two forwards each (one label refinement)
    assert len(calls) == 2 * (4 + 2) + 2 * 2 * 4


@pytest.mark.parametrize("extra", [["--use_attn_dst"],
                                   ["--gat_stabilizer", "per_receiver", "--band_hubs", "off"]])
def test_revgat_app_dense_route_on_cpu(capsys, monkeypatch, extra):
    """--use_attn_dst (and --gat_stabilizer per_receiver) with
    --reorder cluster --band auto: every conv takes the dense route (K7–K9's
    plain versions), with and without the band's hub structures."""
    import deep_gcns_torch_tpu_torch.convs.dgl_gat as tconv

    calls = []
    real = tconv.band_gat_dense_agg
    monkeypatch.setattr(tconv, "band_gat_dense_agg",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    res = ogbn_arxiv_dgl.main(["--synthetic", "--synthetic_nodes", "384", "--epochs", "2",
                               "--device", "cpu", "--n_layers", "3", "--n_hidden", "8",
                               "--n_heads", "2", "--reorder", "cluster", "--band", "auto",
                               "--compute_dtype", "bfloat16"] + extra)
    out = capsys.readouterr().out
    assert math.isfinite(res["loss"]) and 0.0 <= res["best_valid"] <= 1.0
    assert "band attached: window=" in out and "epoch 1 loss" in out
    assert len(calls) == 2 * (4 + 2) + 2 * 2 * 4


@pytest.mark.parametrize("argv,exc", [(["--synthetic", "--mode", "student"], ValueError),
                                      ([], FileNotFoundError)])
def test_revgat_app_raises_for_what_is_not_ported(tmp_path, argv, exc):
    """Student mode needs --teacher_ckpt; without --synthetic and without
    the OGB cache the loader raises."""
    with pytest.raises(exc):
        ogbn_arxiv_dgl.main(argv + ["--device", "cpu", "--epochs", "1",
                                    "--data_root", str(tmp_path)])
