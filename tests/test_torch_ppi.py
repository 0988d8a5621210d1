"""The port's PPI path on the CPU: `DeepGCNStatic` against the JAX package's
on carried-across weights (logits, new BatchNorm state, every gradient) for
each block kind, the weight carry of every conv kind, the reference
checkpoint names, the PPI app's synthetic data against the JAX app's draw
for draw, `convert_ppi_raw` on a tiny raw layout written here, and the app
with its test script.

Tolerances: float32 on both sides through a few blocks, summation order
only (1e-4); gradients rtol 1e-3 with a floor of 1e-5 of the largest.
"""

import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.data.ppi import convert_ppi_raw as jax_convert_ppi_raw
from deep_gcns_torch_tpu.graph import build_graph as jax_build_graph
from deep_gcns_torch_tpu.models.deepgcn import DeepGCNConfig as JaxConfig
from deep_gcns_torch_tpu.models.deepgcn import DeepGCNStatic as JaxDeepGCN
from deep_gcns_torch_tpu_torch.apps import ppi, ppi_test
from deep_gcns_torch_tpu_torch.data.ppi import convert_ppi_raw
from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.models import (DeepGCNCls, DeepGCNConfig, DeepGCNStatic,
                                              DenseDeepGCN, SparseDeepGCN)
from deep_gcns_torch_tpu_torch.utils.import_jax import deepgcn_static_state_dict_from_jax
from deep_gcns_torch_tpu_torch.utils.import_torch import export_deepgcn, import_deepgcn
from torch_budget import budget  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(seed, n=150, e=900, c=12):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, c)).astype(np.float32)
    return build_graph(x, s, r, num_nodes=n), jax_build_graph(x, s, r, num_nodes=n), rng


@pytest.mark.parametrize("block,conv", [("res", "mr"), ("dense", "mr"), ("plain", "edge")])
def test_deepgcn_static_matches_jax(block, conv):
    kw = dict(in_channels=12, n_classes=9, n_filters=16, n_blocks=3, conv=conv, block=block,
              norm="batch", dropout=0.0)
    jcfg = JaxConfig(**kw)
    jmodel = JaxDeepGCN(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    gt, gj, rng = _graphs(1)
    co = rng.standard_normal((gt.num_nodes_padded, 9)).astype(np.float32)
    co[gt.n_node:] = 0.0

    def loss_j(p):
        out, ns = jmodel.apply(p, state, jnp.asarray(gj.x), gj, train=True)
        return jnp.sum(out * co), (out, ns)

    (_, (want, ns)), gp = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    model = DeepGCNStatic(DeepGCNConfig(**kw))
    model.load_state_dict(deepgcn_static_state_dict_from_jax(_np_tree(params),
                                                             _np_tree(state), jcfg))
    model.train()
    out = model(gt.x, gt)
    (out * torch.from_numpy(co)).sum().backward()
    n = gt.n_node
    np.testing.assert_allclose(out.detach().numpy()[:n], np.asarray(want)[:n], **TOL)
    want_s = deepgcn_static_state_dict_from_jax(_np_tree(params), _np_tree(ns), jcfg)
    for k, buf in model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_s[k].numpy(), err_msg=k, **TOL)
    want_g = deepgcn_static_state_dict_from_jax(_np_tree(gp), _np_tree(ns), jcfg)
    named = dict(model.named_parameters())
    assert set(named) <= set(want_g)
    g_max = max(float(np.abs(want_g[k].numpy()).max()) for k in named)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, rtol=1e-3,
                                   atol=1e-5 * g_max)


@pytest.mark.parametrize("conv,act", [("edge", "relu"), ("mr", "relu"), ("gat", "prelu"),
                                      ("gcn", "prelu"), ("gin", "relu"), ("sage", "relu"),
                                      ("rsage", "leakyrelu")])
def test_weight_carry_covers_every_entry(conv, act):
    """`deepgcn_static_state_dict_from_jax` gives exactly the port's
    `state_dict` keys and shapes for each conv (a PReLU's slope included),
    so a strict `load_state_dict` takes it."""
    kw = dict(in_channels=6, n_classes=5, n_filters=8, n_blocks=2, conv=conv, act=act,
              heads=2 if conv == "gat" else 1, block="dense" if conv == "gin" else "res")
    jcfg = JaxConfig(**kw)
    params, state = JaxDeepGCN(jcfg).init(jax.random.PRNGKey(0))
    sd = deepgcn_static_state_dict_from_jax(_np_tree(params), _np_tree(state), jcfg)
    model = DeepGCNStatic(DeepGCNConfig(**kw))
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in own)
    model.load_state_dict(sd)


def test_reference_names_round_trip():
    """The reference PPI model's names (`examples/ppi/architecture.py`):
    an exported `state_dict` loads by name into a fresh model."""
    cfg = DeepGCNConfig(in_channels=6, n_classes=5, n_filters=8, n_blocks=3)
    sd = export_deepgcn(DeepGCNStatic(cfg, torch.Generator().manual_seed(1)))
    for k in ("head.gconv.nn.0.weight", "backbone.1.body.gconv.nn.1.running_var",
              "fusion_block.0.weight", "prediction.0.1.weight", "prediction.2.0.bias",
              "prediction.4.0.weight"):
        assert k in sd, k
    assert not any(k.startswith(("prediction.1", "prediction.3")) for k in sd)
    model = DeepGCNStatic(cfg, torch.Generator().manual_seed(2))
    import_deepgcn(sd, model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    # the point-cloud models (slice 9) share the names of the head and fusion
    for cls in (SparseDeepGCN, DenseDeepGCN, DeepGCNCls):
        names = cls(cfg).state_dict()
        assert "head.gconv.nn.0.weight" in names and "fusion_block.0.weight" in names


def _jax_ppi_app():
    spec = importlib.util.spec_from_file_location(
        "jax_example_ppi", os.path.join(REPO, "examples", "ppi", "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_data_matches_jax():
    args = argparse.Namespace(synthetic=True, in_channels=50, n_classes=121)
    want = _jax_ppi_app().load_ppi(args, np.random.default_rng(4))
    got = ppi.load_ppi(args, np.random.default_rng(4))
    for ws, gs in zip(want, got):
        assert len(ws) == len(gs)
        for a, b in zip(ws, gs):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _write_raw(raw, rng):
    """A tiny GraphSAGE PPI layout: per split a node-link JSON of two graphs
    with contiguous ids, features, labels and graph ids."""
    os.makedirs(raw)
    off = 0
    for split, n_graphs in (("train", 2), ("valid", 1), ("test", 1)):
        links, gid = [], []
        sizes = rng.integers(5, 9, n_graphs)
        start = 0
        for g, n in enumerate(sizes):
            for _ in range(2 * n):
                a, b = rng.integers(0, n, 2)
                links.append({"source": int(start + a), "target": int(start + b)})
            gid += [g + off] * int(n)
            start += int(n)
        off += n_graphs
        with open(os.path.join(raw, f"{split}_graph.json"), "w") as f:
            json.dump({"directed": False, "multigraph": False, "graph": {},
                       "nodes": [{"id": i} for i in range(start)], "links": links}, f)
        np.save(os.path.join(raw, f"{split}_feats.npy"),
                rng.standard_normal((start, 50)).astype(np.float32))
        np.save(os.path.join(raw, f"{split}_labels.npy"),
                (rng.random((start, 121)) < 0.3).astype(np.int64))
        np.save(os.path.join(raw, f"{split}_graph_id.npy"), np.asarray(gid, np.int64))


def test_convert_ppi_raw_matches_jax(tmp_path):
    raw = os.path.join(tmp_path, "ppi_raw")
    _write_raw(raw, np.random.default_rng(5))
    got = np.load(convert_ppi_raw(raw, os.path.join(tmp_path, "port", "ppi.npz")),
                  allow_pickle=True)
    want = np.load(jax_convert_ppi_raw(raw, os.path.join(tmp_path, "jax", "ppi.npz")),
                   allow_pickle=True)
    for split, n_graphs in (("train", 2), ("valid", 1), ("test", 1)):
        assert len(got[split]) == len(want[split]) == n_graphs
        for a, b in zip(got[split], want[split]):
            assert set(a) == set(b) == {"x", "senders", "receivers", "y"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {k}")
            # both edge directions, local ids
            e = set(zip(a["senders"].tolist(), a["receivers"].tolist()))
            assert all((r, s) in e for s, r in e) and max(max(p) for p in e) < len(a["x"])


def test_ppi_app_and_test_script(tmp_path):
    """Two epochs of a small ResMRGCN on the JAX app's synthetic graphs with
    `--save_ckpt`; the test script reproduces the best valid micro-F1 from
    `ckpt_best`. A run without `--save_ckpt` writes nothing; a missing cache
    points at --synthetic."""
    small = ["--synthetic", "--device", "cpu", "--n_blocks", "3", "--n_filters", "16"]
    res = ppi.main(small + ["--epochs", "2", "--save_ckpt", "--exp_root", str(tmp_path)])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["best"] == max(res["f1_valid"])
    scored = ppi_test.main(small + ["--pretrained_model",
                                    os.path.join(res["exp"], "ckpt_best")])
    assert scored["valid"] == res["best"]
    assert scored["meta"]["epoch"] == res["f1_valid"].index(res["best"])
    empty = os.path.join(tmp_path, "none")
    ppi.main(small + ["--epochs", "1", "--exp_root", empty])
    assert not os.path.exists(empty) or os.listdir(empty) == []
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        ppi.main(["--device", "cpu", "--epochs", "1", "--data_root", str(tmp_path)])
