"""The readers of the port's spans: a traced run of the tiny CPU cut of
`revgat5-arxiv-csc` reports each of them, one host read a training step."""

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from conftest import tiny_cell

SPAN_METRICS = {"conv.linear_ms", "conv.attend_ms", "block.norm_ms", "rev.recompute_ms",
                "rev.vjp_ms", "host.syncs", "host.sync_wait_ms"}


def test_a_traced_run_reports_the_span_metrics():
    import run  # noqa: F401  (h100bench/run.py, on the path above)

    out = run.drive(tiny_cell("revgat5-arxiv-csc"), 2 ** 31 + 19, 0.0, True,
                    torch.device("cpu"), 0.0)
    m = out["metrics"]
    assert SPAN_METRICS <= set(m), SPAN_METRICS - set(m)
    assert m["host.syncs"] == {"value": 1.0, "unit": "count/epoch"}
    assert all(m[k]["value"] > 0 for k in SPAN_METRICS)
    assert out["correct"] is True


def test_the_span_readers_read_nothing_without_a_trace():
    from types import SimpleNamespace

    from h100bench import harness

    ctx = SimpleNamespace(trace=None, trace_steps=0)
    for name in sorted(SPAN_METRICS):
        mod = harness.load_module(os.path.join(harness.HERE, "metrics", f"{name}.py"))
        assert mod.read(ctx) is None, name
