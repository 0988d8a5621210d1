"""The port's loss, optimizer, metric and device helpers against the JAX
package's (and optax's)."""

import json
import os

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
    """Every optimizer of the JAX apps' ``--optimizer`` is ported ("adamw"
    is held against JAX in `tests/test_torch_ogbl.py`); an unknown name is
    refused, as the JAX apps' `make_optimizer` refuses it."""
    for name in ("adam", "radam", "adamw_ref", "adamw", "rmsprop"):
        make_optimizer(name, [torch.nn.Parameter(torch.zeros(1))], 1e-2)
    with pytest.raises(ValueError):
        make_optimizer("lamb", [torch.nn.Parameter(torch.zeros(1))], 1e-2)


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


# ---------------------------------------------------------------------------
# the reference-exact optimizers, the schedules, the remaining losses,
# metrics, logging and profiling helpers
# ---------------------------------------------------------------------------

def _run_torch(opt_fn, p0, grads, sched=False):
    p = torch.nn.Parameter(torch.tensor(p0))
    made = opt_fn([p])
    opt, lr_sched = made if sched else (made, None)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        if lr_sched is not None:
            lr_sched.step()
    return p.detach().numpy()


def _run_optax(tx, p0, grads):
    p = jnp.asarray(p0)
    st = tx.init(p)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
    return np.asarray(p)


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_radam_matches_reference_rule_and_jax(wd):
    """Both rectification branches (steps 1-4 un-rectified, 5+ rectified)
    against tests/test_optim_parity.py's numpy transcription of the
    reference and against the JAX package's `radam`."""
    from test_optim_parity import _np_radam_steps

    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(8)]
    got = _run_torch(lambda ps: make_optimizer("radam", ps, 3e-3, wd), p0, grads)
    np.testing.assert_allclose(got, _np_radam_steps(p0, grads, 3e-3, wd), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, _run_optax(joptim.radam(3e-3, wd), p0, grads),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("wd,warmup", [(0.0, 0), (0.02, 4)])
def test_adamw_ref_matches_reference_rule(wd, warmup):
    from deep_gcns_torch_tpu_torch.utils.optim import AdamWRef
    from test_optim_parity import _np_adamw_steps

    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(6,)).astype(np.float32)
    grads = [rng.normal(size=(6,)).astype(np.float32) for _ in range(7)]
    got = _run_torch(lambda ps: AdamWRef(ps, lr=2e-3, weight_decay=wd, warmup=warmup), p0,
                     grads)
    np.testing.assert_allclose(got, _np_adamw_steps(p0, grads, 2e-3, wd, warmup),
                               rtol=2e-5, atol=2e-6)
    if not warmup:
        got = _run_torch(lambda ps: make_optimizer("adamw_ref", ps, 2e-3, wd), p0, grads)
        np.testing.assert_allclose(got, _run_optax(joptim.adamw_ref(2e-3, weight_decay=wd),
                                                   p0, grads), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name,args", [
    ("adamw_warmup", dict(lr=1e-2, warmup_steps=3, total_steps=9, weight_decay=0.01)),
    ("adamw_warmup", dict(lr=1e-2, warmup_steps=0, weight_decay=0.0)),
    ("sgd_cosine", dict(lr=0.1, total_steps=6, momentum=0.9, weight_decay=1e-4, min_lr=0.01)),
    ("sgd_step", dict(lr=0.1, step_size=3, gamma=0.5, momentum=0.9, weight_decay=1e-4))])
def test_scheduled_optimizers_match_jax(name, args):
    """The schedule's value at update k is optax's: the torch optimizer at
    lr 1.0 under a `LambdaLR` against the JAX package's optax chain."""
    from deep_gcns_torch_tpu_torch.utils import optim as toptim

    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(10)]
    got = _run_torch(lambda ps: getattr(toptim, name)(ps, **args), p0, grads, sched=True)
    want = _run_optax(getattr(joptim, name)(**args), p0, grads)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_reduce_lr_on_plateau_matches_jax():
    from deep_gcns_torch_tpu_torch.utils.optim import ReduceLROnPlateau

    metrics = [0.5, 0.6, 0.6, 0.55, 0.59, 0.58, 0.7, 0.1, 0.1, 0.1, 0.1]
    for mode in ("max", "min"):
        a = ReduceLROnPlateau(factor=0.5, patience=2, mode=mode, min_lr=0.2)
        b = joptim.ReduceLROnPlateau(factor=0.5, patience=2, mode=mode, min_lr=0.2)
        assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]


@pytest.mark.parametrize("masked", [False, True])
def test_smooth_cross_entropy_matches_jax(masked):
    from deep_gcns_torch_tpu_torch.utils.loss import smooth_cross_entropy

    rng = np.random.default_rng(6)
    logits = rng.standard_normal((40, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 40)
    mask = rng.random(40) < 0.5 if masked else None

    def f(lg):
        return jloss.smooth_cross_entropy(lg, jnp.asarray(labels), 0.2,
                                          None if mask is None else jnp.asarray(mask))

    want, gwant = jax.value_and_grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = smooth_cross_entropy(lt, torch.from_numpy(labels), 0.2,
                               None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gwant), **TOL)


def test_metrics_match_jax():
    from deep_gcns_torch_tpu.utils import metrics as jm
    from deep_gcns_torch_tpu_torch.utils import metrics as tm

    rng = np.random.default_rng(7)
    scores = rng.standard_normal((200, 5))
    scores[:20, 0] = 0.5  # ties
    labels = (rng.random((200, 5)) < 0.3).astype(float)
    labels[rng.random((200, 5)) < 0.1] = np.nan
    labels[:, 4] = 1.0  # a column without negatives is skipped
    for fn in ("roc_auc", "average_precision"):
        assert getattr(tm, fn)(scores, labels) == pytest.approx(getattr(jm, fn)(scores, labels),
                                                                rel=1e-12)
    pred, lab = rng.integers(0, 6, 300), rng.integers(0, 6, 300)
    for fn in ("accuracy", "balanced_accuracy"):
        assert getattr(tm, fn)(pred, lab) == pytest.approx(getattr(jm, fn)(pred, lab), rel=1e-12)
    logits, multi = rng.standard_normal((50, 8)), rng.random((50, 8)) < 0.4
    assert tm.micro_f1(logits, multi) == pytest.approx(jm.micro_f1(logits, multi), rel=1e-12)
    pos, neg = rng.standard_normal(40), rng.standard_normal(300)
    for k in (10, 50, 400):
        assert tm.hits_at_k(pos, neg, k) == jm.hits_at_k(pos, neg, k)
    a, b = tm.IoUAccumulator(4), jm.IoUAccumulator(4)
    for _ in range(3):
        p, q = rng.integers(0, 3, 100), rng.integers(0, 3, 100)
        a.update(p, q)
        b.update(p, q)
    assert a.miou() == pytest.approx(b.miou(), rel=1e-12) and tm.IoUAccumulator(2).miou() == 0.0
    preds, labs = rng.integers(0, 4, (5, 64)), rng.integers(0, 4, (5, 64))
    np.testing.assert_allclose(tm.part_seg_miou(preds, labs, 4), jm.part_seg_miou(preds, labs, 4),
                               rtol=1e-12)
    ma, mb = tm.AverageMeter(), jm.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1), (0.5, 5)):
        ma.update(v, n)
        mb.update(v, n)
    assert (ma.val, ma.avg, ma.sum, ma.count) == (mb.val, mb.avg, mb.sum, mb.count)


def test_logger_writes_exp_dir_scalars_and_csv(tmp_path):
    from deep_gcns_torch_tpu_torch.utils import logger as tl

    src = tmp_path / "src"
    (src / "pkg").mkdir(parents=True)
    (src / "pkg" / "m.py").write_text("x = 1\n")
    exp = tl.create_exp_dir(str(tmp_path / "runs"), "arxiv", snapshot_src=str(src))
    assert os.path.basename(exp).startswith("arxiv-")
    assert (tmp_path / "runs" / os.path.basename(exp) / "code_snapshot" / "pkg" / "m.py").exists()
    log = tl.setup_logging(exp)
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert "hello" in open(os.path.join(exp, "log.txt")).read()
    sl = tl.ScalarLogger(exp)
    sl.log(3, loss=0.5, acc=0.25)
    sl.log_histogram(3, "w", np.arange(10.0), bins=5)
    rows = [json.loads(x) for x in open(sl.path)]
    assert rows[0] == {"step": 3, "tag": "loss", "value": 0.5}
    assert rows[2]["kind"] == "histogram" and sum(rows[2]["counts"]) == 10
    csv = str(tmp_path / "best.csv")
    tl.save_best_result(csv, "run1", acc=0.7, loss=0.1)
    tl.save_best_result(csv, "run2", acc=0.8, loss=0.2)
    assert open(csv).read().splitlines() == ["name,acc,loss", "run1,0.7,0.1", "run2,0.8,0.2"]


def test_profiling_helpers(tmp_path):
    from deep_gcns_torch_tpu_torch.utils import profiling as tp

    with tp.trace(str(tmp_path / "tr")):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert tp.device_memory_stats("cpu") == {"bytes_in_use": None, "peak_bytes_in_use": None}
    meter = tp.EdgeRateMeter()
    with pytest.raises(RuntimeError):
        meter.update(5)
    meter.start()
    meter.update(1000)
    assert meter.edges == 1000 and meter.rate() >= 0.0
