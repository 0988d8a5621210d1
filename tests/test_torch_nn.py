"""The port's nn/core modules against the JAX package's (outputs, state, grads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_gcns_torch_tpu.nn.core as jc
import deep_gcns_torch_tpu_torch.nn.core as tc

TOL = dict(rtol=1e-5, atol=1e-5)


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

    (_, (y_j, ns_j)), (gp_j, gx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
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

    (_, y_j), (gp, gx) = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
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
