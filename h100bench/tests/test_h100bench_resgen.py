"""`resgen28-arxiv`'s counts: the K2 and K4 cost functions against hand
counts, the kernel calls of a step and of an evaluation against the gather
route's launch arithmetic (each call costed from its own shape), the FLOP
count by hand, and the readers of GENConv's and DeeperGCN's spans on a
traced run of the tiny CPU cut."""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from conftest import tiny_cell
from h100bench import harness

CELL = "resgen28-arxiv-gather"
SPAN_METRICS = {"gen.aggregate_ms", "gen.aggregate_bwd_ms", "gen.mlp_ms", "deeper.norm_ms"}


def cost(k):
    return harness.load_module(os.path.join(harness.HERE, "costs", f"{k}.py"))


def test_k2_k4_hand_counts():
    s = {"n": 10, "e": 30, "e_pad": 32, "c": 4, "bytes": 4, "ee": False, "gw": False}
    # K2: x 10x4, 30 senders, 11 pointers, t, out 10x4, lse 10x4 float32;
    # per (edge, channel) 8 + 16 (expf), per (node, channel) 2 + 16 (logf)
    assert cost("K2").cost(s) == (30 * 4 * 24 + 10 * 4 * 18, 160 + 120 + 44 + 4 + 160 + 160)
    # with ee: 30x4 embeddings more, and the add
    assert cost("K2").cost(dict(s, ee=True)) == (30 * 4 * 25 + 10 * 4 * 18,
                                                 648 + 480)
    # K4's gather form: x, g, lse, dx 10x4 each, 11 pointers, 30 receivers, t;
    # per (edge, channel) 7 + 16
    assert cost("K4").cost(s) == (30 * 4 * 23, 160 * 4 + 44 + 120 + 4)
    # learned t: [g | out] twice as wide, one dt partial a row, 7 more operations
    assert cost("K4").cost(dict(s, gw=True)) == (30 * 4 * 30, 808 + 160 + 40)
    # edge embeddings: ee_csc over the edges read, dee over E_pad rows written
    assert cost("K4").cost(dict(s, ee=True)) == (30 * 4 * 24, 808 + 480 + 512)


def test_kernel_calls_match_the_launch_arithmetic():
    """A step 28 K2 (the forward) and 28 K4 (the backward), an evaluation 28
    K2, each over the whole graph at the cell's width and precision."""
    class G:
        num_nodes_padded, n_edge, num_edges_padded = 256, 1000, 1024
    cell = harness.resolve_cell(CELL)
    calls = cell.config_mod.kernel_calls(cell.config, G)
    assert {k: len(v) for k, v in calls["train_step"].items()} == {"K2": 28, "K4": 28}
    assert {k: len(v) for k, v in calls["predict"].items()} == {"K2": 28}
    for s in calls["train_step"]["K2"] + calls["train_step"]["K4"]:
        assert (s["n"], s["e"], s["c"], s["bytes"], s["ee"], s["gw"]) == \
            (256, 1000, 128, 4, False, False)
    f2, b2 = cost("K2").cost(calls["predict"]["K2"][0])
    assert f2 == 1000 * 128 * 24 + 256 * 128 * 18
    assert b2 == 256 * 128 * 4 * 3 + 1000 * 4 + 257 * 4 + 4


def test_resgen_flops_hand_count():
    cell = harness.resolve_cell(CELL)
    cfg = dict(cell.config, hidden_channels=4, num_classes=3, in_channels=5, num_layers=2)
    n, e = 7, 10
    enc, mlp, head = 2 * n * 5 * 4, 2 * n * 4 * 4, 2 * n * 4 * 3
    fwd = enc + 2 * (mlp + e * 4 * 8) + head
    bwd = enc + 2 * (2 * mlp + e * 4 * 5) + 2 * head
    assert cell.config_mod.flops(cfg, n, e) == {"train_step": pytest.approx(fwd + bwd),
                                                "predict": pytest.approx(fwd)}


def test_a_traced_run_reports_the_span_metrics():
    import run  # noqa: F401  (h100bench/run.py, on the path above)

    out = run.drive(tiny_cell(CELL), 2 ** 31 + 23, 0.0, True, torch.device("cpu"), 0.0)
    m = out["metrics"]
    assert SPAN_METRICS <= set(m), SPAN_METRICS - set(m)
    assert all(m[k]["value"] > 0 for k in SPAN_METRICS)
    assert m["gen.kernel_launches"]["value"] == 0.0  # the CPU runs the plain versions
    assert out["correct"] is True


def test_the_readers_read_nothing_without_a_trace():
    ctx = SimpleNamespace(trace=None, trace_steps=0)
    for name in sorted(SPAN_METRICS | {"K2_roofline", "K4_roofline"}):
        mod = harness.load_module(os.path.join(harness.HERE, "metrics", f"{name}.py"))
        if name.endswith("_roofline"):
            ctx.roofline = lambda k: None
        assert mod.read(ctx) is None, name


def _tiny_job_inputs():
    from h100bench import graphgen

    cell = tiny_cell(CELL)
    inp = graphgen.make_inputs(cell.traffic, 2 ** 31 + 29)
    return cell, harness.build_data(cell.traffic, inp, torch.device("cpu"), 0)


def test_the_job_stops_a_program_that_shifts_by_one_maximum_a_channel():
    """The configuration's set-up probe passes the port's per-receiver shift
    and raises, before any epoch, where the aggregation shifts every
    receiver's softmax by one maximum a channel (the fault that made this
    model's answers wrong on the card)."""
    cell, data = _tiny_job_inputs()
    job = cell.config_mod.Job(cell.config, data, torch.device("cpu"), 1)
    conv = job.model.gcns[0]
    g = data.graph

    def one_maximum_a_channel(x, g, ee, ee_csc):
        v = g.edge_mask
        s, r = g.senders[v].long(), g.receivers[v].long()
        m = torch.relu(x[s]) + conv.eps
        z = conv.t * m
        w = torch.exp(z - z.amax(0))
        num = torch.zeros_like(x).index_add_(0, r, w * m)
        den = torch.zeros_like(x).index_add_(0, r, w)
        return num / den

    conv._aggregate = one_maximum_a_channel
    with pytest.raises(RuntimeError, match="cannot run resgen28-arxiv"):
        cell.config_mod.require_per_receiver_shift(conv, g, cell.config["hidden_channels"])
