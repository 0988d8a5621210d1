"""The port's loss, optimizer, metric and device helpers against the JAX
package's (and optax's)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_gcns_torch_tpu.utils import loss as jloss
from deep_gcns_torch_tpu.utils import optim as joptim
from deep_gcns_torch_tpu_torch.device import resolve_device
from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy
from deep_gcns_torch_tpu_torch.utils.metrics import accuracy
from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((50, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 50)
    mask = rng.random(50) < 0.6 if masked else None

    def f(lg):
        return jloss.cross_entropy(lg, jnp.asarray(labels),
                                   None if mask is None else jnp.asarray(mask))

    want, gwant = jax.value_and_grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(lt, torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gwant), **TOL)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adam_steps_match_optax(weight_decay):
    """Three steps of the port's `make_optimizer("adam", ...)` against the JAX
    package's `adam(lr, weight_decay)` (optax adam, or adamw with decay) from
    the same parameters and gradients."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((6, 4)).astype(np.float32)
    grads = [rng.standard_normal((6, 4)).astype(np.float32) for _ in range(3)]
    tx = joptim.adam(1e-2, weight_decay)
    pj = jnp.asarray(p0)
    st = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer("adam", [pt], 1e-2, weight_decay)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), **TOL)


def test_make_optimizer_rejects_unported():
    with pytest.raises(NotImplementedError):
        make_optimizer("radam", [torch.nn.Parameter(torch.zeros(1))], 1e-2)


def test_accuracy():
    assert accuracy(np.array([1, 2, 3, 4]), np.array([1, 0, 3, 0])) == 0.5


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
