"""DeeperGCN's norm → ReLU → dropout as K11's Function (`ops/norm_act.py`,
`models/deeper_gcn.norm_relu_dropout`) on the CPU: the plain halves with the
running-statistics update and the evaluation form against the eager
`BatchNorm` → ReLU → `dropout` chain, on a masked [N, 128] input with pad
rows. The route is forced here (on the CPU the model takes the eager chain);
the kernels are held against the same halves on the card, in
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu_torch.graph import build_graph
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig
from deep_gcns_torch_tpu_torch.models import deeper_gcn as dg
from deep_gcns_torch_tpu_torch.nn.core import BatchNorm, _frozen_running_stats, dropout
from deep_gcns_torch_tpu_torch.ops import norm_act as tna
from torch_budget import budget  # noqa: F401

N, C, VALID, RATE = 40, 128, 33, 0.5


@pytest.fixture
def k11_route(monkeypatch):
    """`norm_relu_dropout` takes the Function (its plain halves, on the CPU)
    wherever the norm is a `BatchNorm`."""
    monkeypatch.setattr(dg, "_k11_takes", lambda norm, h: isinstance(norm, BatchNorm))


def _norm(dtype, seed=0):
    """A BatchNorm with non-trivial affine and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    m = BatchNorm(C).to(dtype)
    with torch.no_grad():
        m.weight.copy_(torch.rand(C, generator=gen, dtype=dtype) + 0.5)
        m.bias.copy_(torch.randn(C, generator=gen, dtype=dtype) * 0.5)
        m.running_mean.copy_(torch.randn(C, generator=gen, dtype=dtype) * 5.0)
        m.running_var.copy_(torch.rand(C, generator=gen, dtype=dtype) * 4.0 + 0.5)
    return m


def _x(dtype, seed=1):
    """The residual stream's large column means over its spread; pad rows
    hold values that would move the statistics if they were counted."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(N, C, generator=gen, dtype=dtype) * 3.0 + 20.0
    x[VALID:] = 1e3
    return x, torch.arange(N) < VALID


def _run(fused: bool, form: str, dtype, frozen=False):
    """(y, dx, dw, db, the norm, the generator's state after) of one call."""
    norm = _norm(dtype)
    x, mask = _x(dtype)
    x.requires_grad_(True)
    norm.train(form != "eval")
    rate = RATE if form == "train_drop" else 0.0
    gen = torch.Generator().manual_seed(5)
    if fused:
        call = dg.norm_relu_dropout
    else:
        def call(norm, h, mask, rate, train, generator):
            return dropout(torch.relu(norm(h, mask)), rate, train=train, generator=generator)
    if frozen:
        with _frozen_running_stats():
            y = call(norm, x, mask, rate, form != "eval", gen)
    else:
        y = call(norm, x, mask, rate, form != "eval", gen)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(9), dtype=dtype)
    y.backward(dy)
    return y.detach(), x.grad, norm.weight.grad, norm.bias.grad, norm, gen.get_state()


@pytest.mark.parametrize("form", ["train_drop", "train", "eval"])
def test_k11_function_matches_eager_chain(k11_route, form):
    """float64: the output and dx, dw, db (1e-12 relative: the backwards sum
    in different orders, and the eager variance is one-pass); the running
    statistics after the call, num_batches_tracked, and the same draws."""
    got, want = _run(True, form, torch.float64), _run(False, form, torch.float64)
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(got[4], name), getattr(want[4], name), rtol=1e-12,
                                   atol=0.0)
    assert int(got[4].num_batches_tracked) == int(want[4].num_batches_tracked)
    assert int(got[4].num_batches_tracked) == (0 if form == "eval" else 1)
    assert torch.equal(got[5], want[5])
    if form == "train_drop":
        assert int((got[0][:VALID] == 0).sum()) > 0.3 * VALID * C


@pytest.mark.parametrize("form", ["train_drop", "train"])
def test_frozen_running_stats_are_left_alone(k11_route, form):
    """Under `_frozen_running_stats` (a checkpointed recompute) the Function
    normalises by the batch's statistics and moves nothing."""
    y, _, _, _, norm, _ = _run(True, form, torch.float32, frozen=True)
    fresh = _norm(torch.float32)
    assert torch.equal(norm.running_mean, fresh.running_mean)
    assert torch.equal(norm.running_var, fresh.running_var)
    assert int(norm.num_batches_tracked) == 0
    torch.testing.assert_close(y, _run(True, form, torch.float32)[0], rtol=0.0, atol=0.0)


def test_running_update_is_batch_norms(k11_route):
    """float32: the plain half's running update is `BatchNorm`'s own
    arithmetic on the two-pass statistics."""
    norm, ref = _norm(torch.float32), _norm(torch.float32)
    x, mask = _x(torch.float32)
    tna.batch_norm_act_fwd_plain(x, mask, norm.weight.detach(), norm.bias.detach(),
                                 running=(norm.running_mean, norm.running_var, norm.momentum))
    m = mask[:, None].float()
    cnt = m.sum()
    mu = (x * m).sum(0) / cnt
    var = (torch.square(x - mu) * m).sum(0) / cnt
    ref._update_running(mu, var, cnt)
    assert torch.equal(norm.running_mean, ref.running_mean)
    assert torch.equal(norm.running_var, ref.running_var)


def test_evaluation_form_is_the_eager_arithmetic_bit_for_bit():
    """float32, no gradient wanted: relu of `BatchNorm`'s evaluation, bit
    for bit, and no autograd node."""
    norm = _norm(torch.float32).eval()
    x, mask = _x(torch.float32)
    with torch.no_grad():
        got = tna.batch_norm_act_eval_plain(x, norm.running_mean, norm.running_var,
                                            norm.weight, norm.bias, norm.eps)
        assert torch.equal(got, torch.relu(norm(x, mask)))
    assert got.grad_fn is None


def test_keep_mask_is_dropouts_draw(k11_route, monkeypatch):
    """One generator state gives the keep mask that `nn.core.dropout` draws
    from it, and leaves the generator where dropout leaves it."""
    seen = {}

    def spy(*args, **kw):
        seen["keep"] = kw["keep"]
        return tna.batch_norm_act_plain(*args, **kw)

    monkeypatch.setattr(dg, "batch_norm_act", spy)
    x, mask = _x(torch.float32)
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    dg.norm_relu_dropout(_norm(torch.float32), x, mask, RATE, True, g1)
    want = dropout(torch.ones(N, C), RATE, train=True, generator=g2) != 0
    assert torch.equal(seen["keep"], want)
    assert torch.equal(g1.get_state(), g2.get_state())


def _graph(n=300, c=16, seed=0):
    rng = np.random.default_rng(seed)
    return build_graph(rng.standard_normal((n, c)).astype(np.float32),
                       rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n), num_nodes=n)


def _step(cfg, g):
    """Gradients and norm buffers after one forward and backward."""
    model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0))
    model.train()
    gen = torch.Generator().manual_seed(3)
    co = torch.randn(g.num_nodes_padded, cfg.num_tasks,
                     generator=torch.Generator().manual_seed(4))
    (model(g.x, g, gen) * co).sum().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    bufs = {k: b.clone() for k, b in model.named_buffers()}
    return grads, bufs


@pytest.mark.parametrize("knob", ["checkpoint_prologue", "remat"])
def test_checkpointed_model_updates_statistics_once(k11_route, monkeypatch, knob):
    """A res+ DeeperGCN on the Function with ``knob`` on: the running
    statistics move once a step, and the gradients are those without it."""
    calls = []

    def counted(*args, **kw):
        calls.append(kw["running"] is not None)
        return tna.batch_norm_act(*args, **kw)

    monkeypatch.setattr(dg, "batch_norm_act", counted)
    g = _graph()
    base = DeeperGCNConfig(in_channels=16, hidden_channels=C, num_tasks=5, num_layers=3,
                           block="res+", aggr="softmax", t=0.5, norm="batch", dropout=RATE)
    want_g, want_b = _step(base, g)
    assert calls == [True] * 3
    got_g, got_b = _step(dataclasses.replace(base, **{knob: True}), g)
    # the backward recomputes the two prologues, with their statistics frozen
    assert calls[3:] == [True] * 3 + [False] * 2
    for k, v in want_b.items():
        if k.endswith("num_batches_tracked"):
            assert int(got_b[k]) == int(v) == 1, k
        else:
            torch.testing.assert_close(got_b[k], v, rtol=0.0, atol=0.0)
    for k, v in want_g.items():
        torch.testing.assert_close(got_g[k], v, rtol=1e-6, atol=1e-7, msg=k)
