"""The proteins pipeline of the port against the JAX package: the partition
(native and numpy, bit for bit), the synthetic data, the node features from
the edges, the masked BCE, ROC-AUC, the global-norm clip chained before Adam,
and a tiny CPU run of both apps."""

import math
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deep_gcns_torch_tpu.data.partition as jpart
from deep_gcns_torch_tpu.data.ogb import (
    extract_node_features_from_edges as jax_extract_node_features)
from deep_gcns_torch_tpu.utils.loss import bce_with_logits as jax_bce
from deep_gcns_torch_tpu.utils.metrics import roc_auc as jax_roc_auc
from deep_gcns_torch_tpu_torch import native
from deep_gcns_torch_tpu_torch.apps import ogbn_proteins, ogbn_proteins_rev, proteins_common
from deep_gcns_torch_tpu_torch.data import partition as tpart
from deep_gcns_torch_tpu_torch.data.ogb import extract_node_features_from_edges
from deep_gcns_torch_tpu_torch.utils.loss import bce_with_logits
from deep_gcns_torch_tpu_torch.utils.metrics import roc_auc
from deep_gcns_torch_tpu_torch.utils.optim import clip_grad_global_norm_, make_optimizer
from test_torch_graph import assert_same_graph
from torch_budget import budget  # noqa: F401


def _edges(seed, n=500, e=6000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.random((e, 8)).astype(np.float32), n)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kind", ["random", "locality"])
def test_partition_bit_identical(use_native, kind, monkeypatch):
    """Against the JAX package (which uses its own native library): the
    port's native edge extraction, and its numpy version with the native
    library switched off."""
    s, r, ea, n = _edges(0)
    k = 4
    if kind == "random":
        parts_j = jpart.random_partition_graph(np.random.default_rng(1), n, k)
        parts_t = tpart.random_partition_graph(np.random.default_rng(1), n, k)
    else:
        parts_j = jpart.locality_partition_graph(np.random.default_rng(1), s, r, n, k)
        parts_t = tpart.locality_partition_graph(np.random.default_rng(1), s, r, n, k)
    np.testing.assert_array_equal(parts_t, parts_j)
    feats = [np.arange(n, dtype=np.float32)[:, None], np.eye(8, dtype=np.float32)[s[:n] % 8]]
    want = jpart.generate_sub_graphs(s, r, parts_j, k, edge_attr=ea, node_feats=feats,
                                     node_pad=256, edge_pad=2048)
    if use_native:
        assert native.available()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    got = tpart.generate_sub_graphs(s, r, parts_t, k, edge_attr=ea, node_feats=feats,
                                    node_pad=256, edge_pad=2048)
    for gj, gt in zip(want[0], got[0]):
        assert_same_graph(gj, gt)
    for a, b in zip(want[1], got[1]):
        np.testing.assert_array_equal(a, b)
    for fa, fb in zip(want[2], got[2]):
        for a, b in zip(fa, fb):
            np.testing.assert_array_equal(a, b)
    preds = [np.random.default_rng(2).standard_normal((256, 3)).astype(np.float32)
             for _ in range(k)]
    np.testing.assert_array_equal(tpart.scatter_predictions(preds, got[1], n),
                                  jpart.scatter_predictions(preds, want[1], n))


def test_native_partition_matches_numpy_at_default_pads(monkeypatch):
    s, r, ea, n = _edges(3, n=700, e=9000)
    parts = tpart.random_partition_graph(np.random.default_rng(4), n, 5)
    a = tpart.generate_sub_graphs(s, r, parts, 5, edge_attr=ea)
    monkeypatch.setattr(native, "_load", lambda: None)
    b = tpart.generate_sub_graphs(s, r, parts, 5, edge_attr=ea)
    for ga, gb in zip(a[0], b[0]):
        for f in ("senders", "receivers", "edge_attr", "edge_attr_csc", "row_ptr"):
            assert torch.equal(getattr(ga, f), getattr(gb, f)), f


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_node_features_from_edges(aggr):
    s, r, ea, n = _edges(5)
    np.testing.assert_array_equal(extract_node_features_from_edges(s, r, ea, n, aggr),
                                  jax_extract_node_features(s, r, ea, n, aggr))


def test_synthetic_data_matches_the_jax_app():
    import examples.proteins_common as jax_app

    args = types.SimpleNamespace(synthetic=True, synthetic_nodes=700, synthetic_degree=9,
                                 num_tasks=112)
    want = jax_app.load_proteins(args, np.random.default_rng(0))
    got = proteins_common.load_proteins(args, np.random.default_rng(0))
    for k in ("senders", "receivers", "edge_attr", "species", "node_feats", "labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want["splits"]:
        np.testing.assert_array_equal(got["splits"][k], want["splits"][k])


@pytest.mark.parametrize("mask", ["none", "rows", "labels"])
def test_bce_with_logits_matches_jax(mask):
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((40, 7)) * 4).astype(np.float32)
    targets = (rng.random((40, 7)) > 0.5).astype(np.float32)
    targets[rng.random((40, 7)) < 0.1] = np.nan
    m = {"none": None, "rows": rng.random(40) > 0.3,
         "labels": ~np.isnan(targets)}[mask]
    want = float(jax_bce(jnp.asarray(logits), jnp.asarray(targets),
                         None if m is None else jnp.asarray(m)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = bce_with_logits(lt, torch.from_numpy(targets),
                          None if m is None else torch.from_numpy(m))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    assert torch.isfinite(lt.grad).all()


def test_roc_auc_matches_jax():
    rng = np.random.default_rng(7)
    scores = np.round(rng.standard_normal((300, 6)), 1)  # many ties
    labels = (rng.random((300, 6)) > 0.6).astype(np.float64)
    labels[rng.random((300, 6)) < 0.2] = np.nan
    labels[:, 4] = 1.0  # one class only: skipped
    assert roc_auc(scores, labels) == jax_roc_auc(scores, labels)
    assert roc_auc(scores[:, 0], labels[:, 0]) == jax_roc_auc(scores[:, 0], labels[:, 0])
    assert math.isnan(roc_auc(scores[:, 4], labels[:, 4]))


@pytest.mark.parametrize("scale", [10.0, 1e-3])
def test_clip_then_adam_matches_optax(scale):
    """Three steps of clip_by_global_norm(1.0) then Adam(1e-3), clipping
    (scale 10) and not (scale 1e-3)."""
    rng = np.random.default_rng(8)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal(7).astype(np.float32)]
    grads = [[(rng.standard_normal(p.shape) * scale).astype(np.float32) for p in p0]
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    pj = [jnp.asarray(p) for p in p0]
    st = tx.init(pj)
    pt = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer("adam", pt, 1e-3)
    for gs in grads:
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, pj)
        pj = optax.apply_updates(pj, upd)
        clipped = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs],
                                                         None)[0]
        for p, g in zip(pt, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = clip_grad_global_norm_(pt, 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(gs)), rtol=1e-6)
        for p, c in zip(pt, clipped):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6, atol=1e-8)
        opt.step()
    for p, want in zip(pt, pj):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


TINY = ["--synthetic", "--synthetic_nodes", "600", "--synthetic_degree", "12",
        "--num_layers", "3", "--cluster_number", "3", "--eval_parts", "2", "--device", "cpu"]


@pytest.mark.parametrize("app", ["dyresgen", "revgcn"])
def test_apps_train_on_cpu(app, capsys):
    if app == "dyresgen":
        res = ogbn_proteins.main(TINY + ["--epochs", "2", "--eval_every", "1", "--learn_t"])
    else:
        res = ogbn_proteins_rev.main(TINY + ["--epochs", "1", "--compute_dtype",
                                             "bfloat16"])
    assert math.isfinite(res["loss"])
    assert all(0.0 <= v <= 1.0 for v in res["results"].values())
    assert len(res["partition_s"]) == (2 if app == "dyresgen" else 1)
    assert "valid" in capsys.readouterr().out


def test_apps_refuse_what_is_not_ported(tmp_path):
    with pytest.raises(FileNotFoundError, match="--synthetic"):  # no OGB cache there
        ogbn_proteins.main(["--device", "cpu", "--epochs", "1", "--data_root", str(tmp_path)])
    with pytest.raises(ValueError, match="keep no state"):  # BatchNorm in a coupling
        ogbn_proteins_rev.main(TINY + ["--norm", "batch"])
