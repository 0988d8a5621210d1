"""The port's point-cloud models on the CPU: `DenseDeepGCN`, `DeepGCNCls` and
`SparseDeepGCN` against the JAX package's on carried-across weights (logits,
every gradient, the new BatchNorm state), and their reference names (the
data and apps: tests/test_torch_pointcloud_apps.py).

Every kNN a model builds reads a tie-free input: the input seed is the
first whose every recorded kNN input (`KnnReplay`) has `knn_rank_margin`
above 1e-6 of its largest distance, far above the ~1e-7 by which the two
packages' float32 features differ, so both build the same graphs.

Tolerances (float32 through 2-3 blocks): logits and BN state 1e-4 relative
with a floor of 1e-4 of the largest; gradients 1e-3 with a floor of 2e-4 of
the largest parameter gradient (BatchNorm over the few max-pooled rows of a
batch divides by small deviations); bf16 compute 2^-5 with a floor of 2^-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.models.deepgcn import DeepGCNCls as JaxCls
from deep_gcns_torch_tpu.models.deepgcn import DeepGCNConfig as JaxConfig
from deep_gcns_torch_tpu.models.deepgcn import DenseDeepGCN as JaxDense
from deep_gcns_torch_tpu.models.deepgcn import SparseDeepGCN as JaxSparse
from deep_gcns_torch_tpu_torch.models import (DeepGCNCls, DeepGCNConfig, DenseDeepGCN,
                                              SparseDeepGCN)
from deep_gcns_torch_tpu_torch.utils.agreement import KnnReplay, knn_rank_margin
from deep_gcns_torch_tpu_torch.utils.import_jax import (deepgcn_cls_state_dict_from_jax,
                                                        dense_deepgcn_state_dict_from_jax,
                                                        sparse_deepgcn_state_dict_from_jax)
from torch_budget import budget  # noqa: F401

TOL = {None: dict(out=(1e-4, 1e-4), grad=(1e-3, 2e-4)),
       "bfloat16": dict(out=(2.0 ** -5, 2.0 ** -6), grad=(2.0 ** -5, 2.0 ** -6))}
KINDS = {"dense": (JaxDense, DenseDeepGCN, dense_deepgcn_state_dict_from_jax),
         "cls": (JaxCls, DeepGCNCls, deepgcn_cls_state_dict_from_jax),
         "sparse": (JaxSparse, SparseDeepGCN, sparse_deepgcn_state_dict_from_jax)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, what, ref_max=None):
    want = np.asarray(want, np.float32)
    ref = np.abs(want).max() if ref_max is None else ref_max
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol[0],
                               atol=tol[1] * ref + 1e-30, err_msg=what)


def _tie_free_input(model, shape, kind, n_points, k_max):
    """The first seed's uniform input whose every kNN input is tie-free, and
    the model's output shape."""
    for s in range(100):
        x = np.random.default_rng(s).random(shape).astype(np.float32)
        with KnnReplay() as rec, torch.no_grad():
            out = model(torch.from_numpy(x)) if kind == "cls" else \
                model(torch.from_numpy(x), None)
        xs = [xr.reshape(-1, n_points, xr.shape[-1]) for xr, _ in rec.graphs]
        if all(knn_rank_margin(v, k_max) > 1e-6 for v in xs):
            return x, out.shape
    raise AssertionError("no tie-free input")


@pytest.mark.parametrize("kind,block,dtype", [("dense", "res", None), ("dense", "dense", None),
                                              ("dense", "res", "bfloat16"),
                                              ("cls", "res", None), ("sparse", "res", None),
                                              ("sparse", "plain", None)])
def test_point_models_match_jax(kind, block, dtype):
    n_pts = 48
    kw = dict(in_channels=9 if kind != "cls" else 3, n_classes=5, n_filters=16, n_blocks=3,
              conv="edge", block=block, k=4, dropout=0.0, compute_dtype=dtype)
    if kind == "cls":
        kw.update(emb_dims=32, stochastic=False)
        shape = (8, n_pts, 3)
    elif kind == "sparse":
        kw.update(num_points=n_pts)
        shape = (2 * n_pts, 9)
    else:
        shape = (2, n_pts, 9)
    jcls, tcls, carry = KINDS[kind]
    jcfg = JaxConfig(**kw)
    jmodel = jcls(jcfg)
    params, state = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    sd = carry(_np(params), _np(state), jcfg)
    probe = tcls(DeepGCNConfig(**kw))
    probe.load_state_dict(sd)
    x, out_shape = _tie_free_input(probe.train(), shape, kind, n_pts, kw["k"] * 3)

    def apply(p):
        if kind == "cls":
            return jmodel.apply(p, state, jnp.asarray(x), train=True)
        return jmodel.apply(p, state, jnp.asarray(x), None, train=True)

    co = np.random.default_rng(9).standard_normal(tuple(out_shape)).astype(np.float32)

    def loss(p):  # eager, as the JAX package's own tests run it
        out, ns = apply(p)
        return jnp.sum(out * co), (out, ns)

    (_, (want, ns)), gp = jax.value_and_grad(loss, has_aux=True)(params)
    model = tcls(DeepGCNConfig(**kw))
    model.load_state_dict(sd)
    model.train()
    xt = torch.from_numpy(x)
    out = model(xt) if kind == "cls" else model(xt, None)
    (out * torch.from_numpy(co)).sum().backward()
    tol = TOL[dtype]
    _close(out, want, tol["out"], "logits")
    ws = carry(_np(params), _np(ns), jcfg)
    for k, buf in model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            _close(buf, ws[k].numpy(), tol["out"], k)
    wg = carry(_np(gp), _np(ns), jcfg)
    named = dict(model.named_parameters())
    g_max = max(float(np.abs(wg[k].numpy()).max()) for k in named)
    for k, p in named.items():
        _close(p.grad, wg[k].numpy(), tol["grad"], k, g_max)


@pytest.mark.parametrize("kind", ["dense", "cls", "sparse"])
def test_point_model_names(kind):
    """The reference's names (the strict `load_state_dict` of the carry in
    `test_point_models_match_jax` checks that it gives exactly these keys)."""
    kw = dict(in_channels=3, n_classes=4, n_filters=8, n_blocks=3, k=3, emb_dims=16,
              num_points=16)
    own = KINDS[kind][1](DeepGCNConfig(**kw)).state_dict()
    want = {"dense": ("head.gconv.nn.0.weight", "backbone.1.body.gconv.nn.2.running_var",
                      "fusion_block.0.weight", "prediction.1.2.bias", "prediction.3.0.weight"),
            "cls": ("head.gconv.nn.0.weight", "fusion_block.2.weight",
                    "prediction.0.2.running_mean", "prediction.2.0.bias"),
            "sparse": ("head.gconv.nn.0.weight", "backbone.0.body.gconv.nn.1.running_var",
                       "fusion_block.1.weight", "prediction.2.0.weight")}[kind]
    assert all(k in own for k in want), [k for k in want if k not in own]
    assert own["head.gconv.nn.0.weight"].shape[2:] == ((1, 1) if kind != "sparse" else ())
    if kind == "cls":
        assert "head.gconv.nn.0.bias" not in own and "fusion_block.0.bias" not in own
