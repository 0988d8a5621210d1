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
from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy, kd_loss
from deep_gcns_torch_tpu_torch.utils.metrics import accuracy
from deep_gcns_torch_tpu_torch.utils.optim import linear_schedule, make_optimizer

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


@pytest.mark.parametrize("init,weight_decay", [(0.0, 0.0), (2e-3 / 50, 0.05)])
def test_rmsprop_with_warmup_matches_optax(init, weight_decay):
    """Six updates of `make_optimizer("rmsprop", ...)` at lr 1.0 under a
    `LambdaLR` of `linear_schedule` against the JAX package's
    `rmsprop(optax.linear_schedule(...), weight_decay)`: the warm-up of
    bench.py:132 (from 0, so the first update is exactly zero) and the app's
    (from lr/50), over the end of the transition."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(6)]
    tx = joptim.rmsprop(optax.linear_schedule(init, 2e-3, 4), weight_decay)
    pj = jnp.asarray(p0)
    st = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer("rmsprop", [pt], 1.0, weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, linear_schedule(init, 2e-3, 4))
    for i, g in enumerate(grads):
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        if i == 0 and init == 0.0 and not weight_decay:
            np.testing.assert_array_equal(pt.detach().numpy(), p0)
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("steps", [50, 0])
def test_linear_schedule_matches_optax(steps):
    """optax evaluates the schedule in float32, the port in float64."""
    want = optax.linear_schedule(2e-3 / 50, 2e-3, steps)
    got = linear_schedule(2e-3 / 50, 2e-3, steps)
    for k in (0, 1, 7, 49, 50, 51, 500):
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_kd_loss_matches_jax(masked):
    rng = np.random.default_rng(3)
    s = rng.standard_normal((40, 6)).astype(np.float32) * 3
    t = rng.standard_normal((40, 6)).astype(np.float32) * 3
    mask = rng.random(40) < 0.5 if masked else None

    def f(s_):
        return jloss.kd_loss(s_, jnp.asarray(t), 0.7,
                             None if mask is None else jnp.asarray(mask))

    want, gwant = jax.value_and_grad(f)(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    got = kd_loss(st, torch.from_numpy(t), 0.7, None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gwant), **TOL)


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
