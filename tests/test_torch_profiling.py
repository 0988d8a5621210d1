"""The port's spans (`utils/profiling.span`): the gate, the stretches, the
per-thread parents, the clock they share with `torch.profiler`, and the
spans one RevGAT-5L train step and one evaluation record, on the CPU and on
the card. The file imports no JAX; its card test runs with

    pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep_gcns_torch_tpu_torch.utils import profiling
from deep_gcns_torch_tpu_torch.utils.profiling import span, spans_on
from torch_budget import budget  # noqa: F401


def _names():
    return [r.name for r in profiling.records()]


def test_spans_record_only_under_a_profiler_or_spans_on():
    with spans_on():
        with span("forced"):
            pass
    assert _names() == ["forced"]
    # shut: one shared null context, nothing recorded
    assert span("a") is span("b")
    with span("off"):
        pass
    assert "off" not in _names()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("first"):
            torch.ones(4).sum()
    assert _names() == ["first"]  # a new stretch starts empty
    with span("between"):  # unprofiled work between two stretches
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
    assert set(profiling.summary()) == {"second"}
    with profile(activities=[ProfilerActivity.CPU]):  # after a read
        with span("third"):
            pass
    s = profiling.summary()
    assert set(s) == {"third"} and s["third"]["count"] == 1


def test_summary_sums_by_name_and_takes_the_children_off_the_self_time():
    with spans_on():
        with span("outer"):
            for _ in range(3):
                with span("inner"):
                    torch.randn(64, 64) @ torch.randn(64, 64)
    s = profiling.summary()
    assert s["inner"]["count"] == 3 and s["outer"]["count"] == 1
    assert s["inner"]["self_ms"] == s["inner"]["device_ms"]
    np.testing.assert_allclose(s["outer"]["self_ms"],
                               s["outer"]["device_ms"] - s["inner"]["device_ms"], rtol=1e-9)
    assert 0 <= s["outer"]["self_ms"] <= s["outer"]["device_ms"]
    assert s["outer"]["host_ms"] >= s["inner"]["host_ms"] > 0


def test_parents_are_kept_per_thread():
    seen = {}

    def other():
        seen["thread"] = threading.get_ident()
        with span("t.outer"):
            with span("t.inner"):
                pass

    with spans_on():
        with span("outer"):
            with span("inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join()
    recs = {r.name: r for r in profiling.records()}
    assert recs["outer"].parent is None and recs["inner"].parent is recs["outer"]
    # opened while "inner" was open on the main thread, yet its own root
    assert recs["t.outer"].parent is None and recs["t.inner"].parent is recs["t.outer"]
    assert recs["t.outer"].thread == seen["thread"] != recs["outer"].thread


def test_a_span_holds_the_profilers_events_of_its_ops():
    """The spans' host clock is the profiler's: the `aten::` ops launched
    inside a span start and end inside its host interval."""
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mm"):
            for _ in range(4):
                torch.mm(a, b)
    (rec,) = [r for r in profiling.records() if r.name == "mm"]
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(ops) == 4
    for e in ops:
        assert rec.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= rec.end_ns


def _tiny_revgat(dev=torch.device("cpu")):
    """RevGAT-5L (group 2, edge-drop and dropout on) through the arxiv app's
    train_step and predict on a CSC-route graph of 200 nodes on ``dev``."""
    from deep_gcns_torch_tpu_torch.apps import ogbn_arxiv_dgl as app
    from deep_gcns_torch_tpu_torch.graph import add_self_loops, build_graph
    from deep_gcns_torch_tpu_torch.models import RevGAT, RevGATConfig

    rng = np.random.default_rng(0)
    n = 200
    s, r = add_self_loops(rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n), n)
    g = build_graph(rng.standard_normal((n, 16)).astype(np.float32), s, r,
                    num_nodes=n).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    model = RevGAT(RevGATConfig(in_feats=16, n_classes=5, n_hidden=8, n_layers=5, n_heads=2,
                                group=2, dropout=0.2, input_drop=0.1, edge_drop=0.3),
                   generator=torch.Generator().manual_seed(2)).to(dev)
    opt = torch.optim.RMSprop(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda e: 1.0)
    labels = torch.from_numpy(rng.integers(0, 5, g.num_nodes_padded)).to(dev)

    def step():
        app.train_step(model, opt, sched, g, g.x, labels, g.node_mask, gen)

    def evaluate():
        app.predict(model, g, g.x, None, g.node_mask, 0)
    return step, evaluate


def _counts():
    out = {}
    for r in profiling.records():
        key = (r.name, None if r.parent is None else r.parent.name)
        out[key] = out.get(key, 0) + 1
    return out


FWD = {("conv.linear", None): 16, ("conv.attend", None): 8, ("block.norm", None): 7}
STEP = {**FWD, ("rev.recompute", None): 6, ("rev.vjp", None): 6, ("host.sync", None): 1,
        ("conv.linear", "rev.recompute"): 12, ("conv.attend", "rev.recompute"): 6,
        ("block.norm", "rev.recompute"): 6}


def test_revgat_step_and_evaluation_span_counts():
    """A forward: 8 convs, each with two `conv.linear` (fc, res_fc) and one
    `conv.attend`, and 7 `block.norm` (6 group blocks, the head). The
    reversible backward recomputes each of the 3 × 2 group functions once
    under `rev.recompute`, with its spans inside, and takes one `rev.vjp`
    each. One `host.sync` a step (the drop keys), none in `predict`."""
    step, evaluate = _tiny_revgat()
    with spans_on():
        step()
    assert _counts() == STEP
    with spans_on():
        evaluate()
    assert _counts() == FWD


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run `pytest --noconftest -m cuda "
                    "tests/test_torch_profiling.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_revgat_spans_on_the_card(cuda_device):
    """On the card the same spans, timed by CUDA events: the reversible
    backward's spans open on autograd's device thread, where the recompute
    is the parent of its convs' spans; `summary()` reads every event."""
    step, evaluate = _tiny_revgat(cuda_device)
    step()  # builds the kernels
    with spans_on():
        step()
    assert _counts() == STEP
    main = threading.get_ident()
    for r in profiling.records():
        assert (r.thread != main) == (r.name.startswith("rev.")
                                      or r.parent is not None), r.name
    s = profiling.summary()
    assert all(v["device_ms"] > 0 for v in s.values())
    assert all(r.events is None and r.device_ms > 0 for r in profiling.records())
    with spans_on():
        evaluate()
    assert _counts() == FWD
