"""The port's nn/core modules against the JAX package's (outputs, state, grads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.nn.core as jc
import deep_gcns_torch_tpu_torch.nn.core as tc
from torch_budget import budget  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
# a gradient rounded once to bf16: one ulp (2^-7 relative at most) when
# float32 summation order flips the rounding
BF16_GRAD_TOL = dict(rtol=2.0 ** -7, atol=0)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _data(seed=0, n=64, c=12, n_valid=50):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, c)) * 2 + 0.5).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:n_valid] = True
    co = rng.standard_normal((n, c)).astype(np.float32)
    return x, mask, co


def test_linear_matches_jax_and_init_bound():
    x, _, _ = _data(c=10)
    lin = tc.Linear(10, 6, generator=torch.Generator().manual_seed(0))
    bound = 1 / np.sqrt(10)
    assert float(lin.weight.detach().abs().max()) <= bound
    assert float(lin.bias.detach().abs().max()) <= bound
    p = {"w": jnp.asarray(lin.weight.detach().numpy().T),
         "b": jnp.asarray(lin.bias.detach().numpy())}
    want, _ = jc.Linear(10, 6).apply(p, {}, jnp.asarray(x))
    _close(lin(torch.from_numpy(x)).detach(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_matches_jax(masked):
    x, mask, co = _data()
    bn = tc.BatchNorm(12)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
    p = {"scale": jnp.asarray(bn.weight.detach().numpy()),
         "bias": jnp.asarray(bn.bias.detach().numpy())}
    s = {"mean": jnp.zeros(12), "var": jnp.ones(12)}
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    mod = jc.BatchNorm(12)

    def loss_j(p, x_):
        y, ns = mod.apply(p, s, x_, train=True, mask=m_j)
        return jnp.sum(y * co), (y, ns)

    (_, (y_j, ns_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = bn(xt, m_t)
    (y_t * torch.from_numpy(co)).sum().backward()
    _close(y_t.detach(), y_j)
    _close(bn.running_mean, ns_j["mean"])
    _close(bn.running_var, ns_j["var"])
    _close(xt.grad, gx_j)
    _close(bn.weight.grad, gp_j["scale"])
    _close(bn.bias.grad, gp_j["bias"])
    bn.eval()
    y_e, _ = mod.apply(p, ns_j, jnp.asarray(x), train=False)
    _close(bn(torch.from_numpy(x)).detach(), y_e)


def test_layernorm_and_instancenorm_match_jax():
    x, mask, _ = _data(seed=2)
    ln = tc.LayerNorm(12)
    y_j, _ = jc.LayerNorm(12).apply({"scale": jnp.ones(12), "bias": jnp.zeros(12)}, {},
                                   jnp.asarray(x))
    _close(ln(torch.from_numpy(x)).detach(), y_j)
    inn = tc.InstanceNorm(12)
    for m in (None, mask):
        y_j, _ = jc.InstanceNorm(12).apply({}, {}, jnp.asarray(x),
                                           mask=None if m is None else jnp.asarray(m))
        _close(inn(torch.from_numpy(x), None if m is None else torch.from_numpy(m)), y_j)


def test_mlp_matches_jax_with_reference_names():
    x, mask, co = _data(seed=3, c=8)
    mlp = tc.MLP([8, 16, 5], norm="batch", last_lin=True,
                 generator=torch.Generator().manual_seed(0))
    assert set(mlp.state_dict()) == {
        "0.weight", "0.bias", "1.weight", "1.bias", "1.running_mean", "1.running_var",
        "1.num_batches_tracked", "3.weight", "3.bias"}
    sd = {k: jnp.asarray(v.numpy()) for k, v in mlp.state_dict().items()}
    p = [{"lin": {"w": sd["0.weight"].T, "b": sd["0.bias"]},
          "norm": {"scale": sd["1.weight"], "bias": sd["1.bias"]}},
         {"lin": {"w": sd["3.weight"].T, "b": sd["3.bias"]}}]
    s = [{"norm": {"mean": sd["1.running_mean"], "var": sd["1.running_var"]}}, {}]
    mod = jc.MLP((8, 16, 5), norm="batch", last_lin=True)
    co5 = co[:, :5]

    def loss_j(p, x_):
        y, _ = mod.apply(p, s, x_, train=True, mask=jnp.asarray(mask))
        return jnp.sum(y * co5), y

    (_, y_j), (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = mlp(xt, torch.from_numpy(mask))
    (y_t * torch.from_numpy(co5)).sum().backward()
    _close(y_t.detach(), y_j)
    _close(xt.grad, gx)
    _close(mlp[0].weight.grad.T, gp[0]["lin"]["w"])
    _close(mlp[1].weight.grad, gp[0]["norm"]["scale"])
    _close(mlp[3].bias.grad, gp[1]["lin"]["b"])


def test_dropout_scales_and_masks():
    x = torch.ones(1000, 4)
    y = tc.dropout(x, 0.5, train=True, generator=torch.Generator().manual_seed(0))
    vals = set(np.unique(y.numpy()).tolist())
    assert vals <= {0.0, 2.0} and 0.4 < float((y == 0).float().mean()) < 0.6
    assert tc.dropout(x, 0.5, train=False) is x


def _old_bf16_linear(x, lin):
    """The port's product before the repair: torch rounds the bf16 product to
    bf16 before the float32 bias."""
    return torch.nn.functional.linear(x.bfloat16(), lin.weight.bfloat16()).float() + lin.bias


def test_bf16_linear_keeps_the_float32_product():
    """compute_dtype=bf16: the port returns JAX's float32-accumulated product
    of the bf16-rounded inputs (`preferred_element_type=float32`), within
    float32 summation order; the old bf16-rounded product misses by up to a
    bf16 ulp."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((256, 128)) * 3).astype(np.float32)
    lin = tc.Linear(128, 96, generator=torch.Generator().manual_seed(0))
    p = {"w": jnp.asarray(lin.weight.detach().numpy().T),
         "b": jnp.asarray(lin.bias.detach().numpy())}
    want, _ = jc.Linear(128, 96).apply(p, {}, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    got = lin(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    old = _old_bf16_linear(torch.from_numpy(x), lin).detach().numpy()
    assert np.abs(old - np.asarray(want)).max() > 1e-3


def test_bf16_linear_backward_rounds_like_a_bf16_product():
    """The backward of the float32-accumulated bf16 product against jax.grad:
    JAX's transpose rule meets the float32 cotangent with the bf16-rounded
    other input and rounds each gradient once to bf16. Within one bf16 ulp
    (float32 summation order can flip a rounding); rounding the cotangent to
    bf16 first, as a bf16 product on the TPU would, misses by far more."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    co = rng.standard_normal((64, 16)).astype(np.float32)
    lin = tc.Linear(32, 16, generator=torch.Generator().manual_seed(1))
    p = {"w": jnp.asarray(lin.weight.detach().numpy().T),
         "b": jnp.asarray(lin.bias.detach().numpy())}

    def loss(p, x):
        return (jc.Linear(32, 16).apply(p, {}, x, compute_dtype=jnp.bfloat16)[0] * co).sum()

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (lin(xt, torch.bfloat16) * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **BF16_GRAD_TOL)
    np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(gp["w"]),
                               **BF16_GRAD_TOL)
    _close(lin.bias.grad, gp["b"])
    cb = torch.from_numpy(co).bfloat16().float()
    rounded = (torch.from_numpy(x).bfloat16().float().t() @ cb).bfloat16().float().numpy()
    assert np.abs(rounded - np.asarray(gp["w"])).max() > 1e-2


def _mlp_params(mlp):
    """The JAX MLP's params and state from a port MLP's state_dict."""
    sd = {k: jnp.asarray(v.numpy()) for k, v in mlp.state_dict().items()}
    p = [{"lin": {"w": sd["0.weight"].T, "b": sd["0.bias"]},
          "norm": {"scale": sd["1.weight"], "bias": sd["1.bias"]}},
         {"lin": {"w": sd["3.weight"].T, "b": sd["3.bias"]}}]
    s = [{"norm": {"mean": sd["1.running_mean"], "var": sd["1.running_var"]}}, {}]
    return p, s


def test_bf16_mlp_gradients_match_jax():
    """Every gradient of a bf16 MLP (Lin → BatchNorm → ReLU → Lin) against
    jax.grad. The float32 BatchNorm backward sums in another order than
    XLA's, which can flip the bf16 rounding of a Linear gradient by one ulp;
    the gradients upstream of it sum such flips, hence the absolute floor. It
    is set by the largest gradient of all: the first bias feeds a BatchNorm,
    so its true gradient is 0 and both sides return rounding noise."""
    x, mask, _ = _data(seed=7, n=128, c=64)
    co = np.random.default_rng(8).standard_normal((128, 48)).astype(np.float32)
    mlp = tc.MLP([64, 128, 48], norm="batch", last_lin=True,
                 generator=torch.Generator().manual_seed(3))
    p, s = _mlp_params(mlp)
    jm = jc.MLP((64, 128, 48), norm="batch", last_lin=True)

    def loss(p, x):
        y, _ = jm.apply(p, s, x, train=True, mask=jnp.asarray(mask),
                        compute_dtype=jnp.bfloat16)
        return (y * co).sum()

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (mlp(xt, torch.from_numpy(mask), torch.bfloat16) * torch.from_numpy(co)).sum().backward()
    want = {"0.weight": gp[0]["lin"]["w"].T, "0.bias": gp[0]["lin"]["b"],
            "1.weight": gp[0]["norm"]["scale"], "1.bias": gp[0]["norm"]["bias"],
            "3.weight": gp[1]["lin"]["w"].T, "3.bias": gp[1]["lin"]["b"]}
    want = {k: np.asarray(v) for k, v in list(want.items()) + [("x", gx)]}
    got = {k: v.grad.numpy() for k, v in list(mlp.named_parameters()) + [("x", xt)]}
    g_max = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2.0 ** -7, atol=1e-4 * g_max,
                                   err_msg=k)


def test_bf16_mlp_matches_jax():
    x, mask, _ = _data(seed=6, n=128, c=64)
    mlp = tc.MLP([64, 128, 48], norm="batch", last_lin=True,
                 generator=torch.Generator().manual_seed(2))
    p, s = _mlp_params(mlp)
    want, _ = jc.MLP((64, 128, 48), norm="batch", last_lin=True).apply(
        p, s, jnp.asarray(x), train=True, mask=jnp.asarray(mask), compute_dtype=jnp.bfloat16)
    got = mlp(torch.from_numpy(x), torch.from_numpy(mask), torch.bfloat16)
    # float32 summation order, which can flip the bf16 rounding of the second
    # layer's input by one ulp (max error 1.6e-4 here; the old bf16-rounded
    # product missed by 5.6e-3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3, atol=5e-4)
