"""The port's dense point-cloud convs on the CPU against the JAX package's
(`convs/dense.py:30-345`), through the weight carry
(`utils.import_jax.basic_conv_entries`): outputs, the input's gradient,
every parameter's gradient and BatchNorm's new running state, in float32 and
with ``compute_dtype="bfloat16"``.

The kNN inputs are tie-free (`knn_rank_margin` above 1e-6, as in
tests/test_torch_knn.py); the maxima over k do tie, and must: relu then
BatchNorm maps a channel whose k pre-activations are all ≤ 0 to k equal
values, and the tests assert such rows are present, so the even split of
the gradient over ties (`torch.amax`, JAX's `jnp.max`) is held.

Tolerances: float32 outputs and BN state 1e-4 relative with a floor of
1e-5 of the largest value (summation order of the product and of BN's two
moments over B·N·K positions); float32 gradients 1e-3 with a floor of 1e-4
of the largest (of any parameter's, for the parameters' gradients). bf16: products of bf16 values accumulated in float32 on
both sides, but each side rounds the cotangent of the bf16 edge features
once to bf16 (an ulp is 2^-8 relative) and sums them in its own order, so
gradients 2^-5 relative with a floor of 2^-6 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.convs import dense as jd
from deep_gcns_torch_tpu_torch.convs import dense as td
from deep_gcns_torch_tpu_torch.ops import knn as tknn
from deep_gcns_torch_tpu_torch.utils.agreement import knn_rank_margin, max_over_k_near_ties
from deep_gcns_torch_tpu_torch.utils.import_jax import basic_conv_entries
from torch_budget import budget  # noqa: F401

F32 = dict(out=(1e-4, 1e-5), grad=(1e-3, 1e-4))
BF16 = dict(out=(2.0 ** -6, 2.0 ** -7), grad=(2.0 ** -5, 2.0 ** -6))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, what, ref_max=None):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    rtol, floor = tol
    ref = np.abs(want).max() if ref_max is None else ref_max
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * ref + 1e-30, err_msg=what)


def _points(seed, b, n, c, k):
    for s in range(seed, seed + 1000):
        x = np.random.default_rng(s).standard_normal((b, n, c)).astype(np.float32)
        if knn_rank_margin(torch.from_numpy(x), k) > 1e-6:
            return x
    raise AssertionError("no tie-free draw")


def _carry(prefix, params, state, act, norm):
    sd = {}
    basic_conv_entries(sd, prefix, _np(params), _np(state), act, norm)
    return {k.lstrip("."): v for k, v in sd.items()}


def _run(jmod, tmod, prefix, act, norm, x, call_j, call_t, dtype, rng):
    """Forward and backward of both under one random cotangent; compares
    everything the module owns."""
    params, state = jax.jit(jmod.init)(jax.random.PRNGKey(1))
    tmod.load_state_dict(_carry(prefix, params, state, act, norm), strict=True)
    tmod.train()
    out0, _ = call_j(params, state, jnp.asarray(x))
    co = rng.standard_normal(out0.shape).astype(np.float32)

    def loss(p, xx):
        out, ns = call_j(p, state, xx)
        return jnp.sum(out * co), (out, ns)

    (_, (want, ns)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = call_t(xt)
    (out * torch.from_numpy(co)).sum().backward()
    tol = F32 if dtype is None else BF16
    _close(out, want, tol["out"], "out")
    _close(xt.grad, gx, tol["grad"], "dx")
    wg = _carry(prefix, gp, ns, act, norm)
    # a bias before BatchNorm has a zero gradient in exact arithmetic: its
    # floor is the largest parameter gradient's
    g_max = max(float(np.abs(wg[k].numpy()).max()) for k, _ in tmod.named_parameters())
    for k, p in tmod.named_parameters():
        _close(p.grad, wg[k].numpy(), tol["grad"], k, g_max)
    ws = _carry(prefix, params, ns, act, norm)
    for k, buf in tmod.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            _close(buf, ws[k].numpy(), F32["out"], k)
    return out


@pytest.mark.parametrize("act,norm", [("relu", "batch"), ("leakyrelu", "instance"),
                                      ("prelu", None), (None, "batch")])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_basic_conv_matches_jax(act, norm, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 3, 12)).astype(np.float32)
    jm = jd.BasicConv((12, 24), act, norm, compute_dtype=dtype)
    tm = td.BasicConv([12, 24], act, norm, compute_dtype=dtype)
    _run(jm, tm, "", act, norm, x,
         lambda p, s, xx: jm.apply(p, s, xx, train=True), lambda xx: tm(xx), dtype, rng)


def test_batch_norm2d_eval_and_state_match_jax():
    """Eval reads the running state; one train step moves it by momentum
    0.1 with the unbiased variance (count B·N·K)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 10, 4, 6)) * 2 + 1).astype(np.float32)
    jm = jd.BatchNorm2d(6)
    p = {"scale": jnp.asarray(rng.random(6) + 0.5, jnp.float32),
         "bias": jnp.asarray(rng.standard_normal(6), jnp.float32)}
    s = {"mean": jnp.asarray(rng.standard_normal(6), jnp.float32),
         "var": jnp.asarray(rng.random(6) + 0.5, jnp.float32)}
    tm = td.BatchNorm2d(6)
    tm.load_state_dict({"weight": torch.from_numpy(np.asarray(p["scale"])),
                        "bias": torch.from_numpy(np.asarray(p["bias"])),
                        "running_mean": torch.from_numpy(np.asarray(s["mean"])),
                        "running_var": torch.from_numpy(np.asarray(s["var"])),
                        "num_batches_tracked": torch.tensor(0)})
    tm.eval()
    want, _ = jm.apply(p, s, jnp.asarray(x), train=False)
    _close(tm(torch.from_numpy(x)), want, F32["out"], "eval")
    tm.train()
    want, ns = jm.apply(p, s, jnp.asarray(x), train=True)
    _close(tm(torch.from_numpy(x)), want, F32["out"], "train")
    _close(tm.running_mean, ns["mean"], F32["out"], "mean")
    _close(tm.running_var, ns["var"], F32["out"], "var")
    assert int(tm.num_batches_tracked) == 1


def _conv_case(conv, dtype, block=None, d=1):
    b, n, c, k = 2, 48, 16, 4
    x = _points(2, b, n, c, k * d)
    rng = np.random.default_rng(3)
    if block is None:
        nn_idx = tknn.dilated_knn_graph_dense(torch.from_numpy(x), k, d)[0]
        jm = jd.graph_conv2d(c, 24, conv, "relu", "batch", compute_dtype=dtype)
        tm = td.graph_conv2d(c, 24, conv, "relu", "batch", compute_dtype=dtype)
        ei_j = (jnp.asarray(nn_idx.numpy()), None)
        ei_t = (nn_idx, None)
        out = _run(jm, tm, "nn", "relu", "batch", x,
                   lambda p, s, xx: jm.apply(p, s, xx, ei_j, train=True),
                   lambda xx: tm(xx, ei_t), dtype, rng)
        return tm, torch.from_numpy(x), nn_idx, out
    make_j = {"plain": jd.PlainDynBlock2d, "res": jd.ResDynBlock2d,
              "dense": jd.DenseDynBlock2d}[block]
    make_t = {"plain": td.PlainDynBlock2d, "res": td.ResDynBlock2d,
              "dense": td.DenseDynBlock2d}[block]
    kw = dict(kernel_size=k, dilation=d, conv=conv, norm="batch", compute_dtype=dtype)
    if block == "dense":
        jm, tm = make_j(c, 24, **kw), make_t(c, 24, **kw)
    else:
        jm, tm = make_j(c, **kw), make_t(c, **kw)
    _run(jm, tm, "body.gconv.nn", "relu", "batch", x,
         lambda p, s, xx: jm.apply(p, s, xx, None, train=True), lambda xx: tm(xx), dtype, rng)


@pytest.mark.parametrize("conv", ["edge", "mr"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_graph_conv2d_matches_jax(conv, dtype):
    tm, x, nn_idx, _ = _conv_case(conv, dtype)
    if conv == "edge":
        # the data holds exact ties of the max over k (relu then BN)
        with torch.no_grad():
            xe = x if dtype is None else x.to(torch.bfloat16)
            x_j = td.gather_neighbors(xe, nn_idx)
            y = tm.nn(torch.cat([xe[:, :, None].expand_as(x_j), x_j - xe[:, :, None]], -1))
        top2 = torch.topk(y, 2, dim=2).values
        assert int((top2[:, :, 0] == top2[:, :, 1]).sum()) > 0
        assert bool(max_over_k_near_ties(y, 0.0).any())


@pytest.mark.parametrize("block,d", [("plain", 1), ("res", 2), ("dense", 3)])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_dyn_blocks_match_jax(block, d, dtype):
    """`DynConv2d` builds its kNN (dilation d) from its input inside each
    block kind."""
    _conv_case("edge", dtype, block, d)


def test_dyn_conv2d_names_and_centres():
    """Reference names; explicit centres are checked on the host (the
    canonical arange passes, any other raises); the instance norm keeps no
    state."""
    m = td.DynConv2d(6, 8, kernel_size=3, norm="batch")
    assert set(m.state_dict()) == {
        "gconv.nn.0.weight", "gconv.nn.0.bias", "gconv.nn.2.weight", "gconv.nn.2.bias",
        "gconv.nn.2.running_mean", "gconv.nn.2.running_var", "gconv.nn.2.num_batches_tracked"}
    assert m.gconv.nn[0].weight.shape == (8, 12, 1, 1)
    x = torch.randn(2, 10, 6)
    nn_idx, centers = tknn.dilated_knn_graph_dense(x, 3)
    m(x, (nn_idx, centers))
    with pytest.raises(ValueError, match="canonical"):
        m(x, (nn_idx, centers.flip(1)))
    assert td.BasicConv([6, 8], "relu", "instance").state_dict().keys() == {"0.weight", "0.bias"}
    got = td.batched_index_select(x, nn_idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd.batched_index_select(
        jnp.asarray(x.numpy()), jnp.asarray(nn_idx.numpy()))))
