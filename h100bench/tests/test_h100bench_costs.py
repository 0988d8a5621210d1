"""The kernel cost functions and the configurations' FLOP counts against
hand counts at a small shape, and the roofline arithmetic."""

import os

import pytest

from h100bench import harness, peaks


def cost(k):
    return harness.load_module(os.path.join(harness.HERE, "costs", f"{k}.py"))


def test_k5_k6_hand_counts():
    s = {"n": 10, "e": 30, "e_work": 20.0, "p": 8, "h": 2, "d": 3, "bytes": 4, "drop": True}
    # K5: table 10x8, senders and receivers 30 each, 11 pointers, cmax 2, out 10x8
    assert cost("K5").cost(s) == (20.0 * (8 + 12), 320 + 240 + 44 + 8 + 320)
    # K6: table and cotangent 10x8 each, 11 pointers, 30 receivers, 30 keep flags, cmax, dT
    assert cost("K6").cost(s) == (20.0 * (8 + 24), 640 + 44 + 120 + 30 + 8 + 320)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(67e12, 1.0) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_revgat_flops_hand_count():
    mod = harness.resolve_cell("revgat5-arxiv-csc").config_mod
    cfg = {"n_heads": 2, "n_hidden": 4, "group": 2, "in_channels": 5, "num_classes": 3,
           "use_labels": True, "n_layers": 3, "edge_drop": 0.5, "n_label_iters": 1}
    n, e = 7, 10
    # convs: (8 in, 2 heads of 4), two group convs (4 in, 2 heads of 2), last (8 in, 1 of 3)
    convs = [(8, 2, 4), (4, 2, 2), (4, 2, 2), (8, 1, 3)]
    fwd_t = fwd_e = bwd = 0.0
    for i, (fin, h, d) in enumerate(convs):
        mm = 4 * n * fin * h * d
        att = 4 * h + 2 * h * d
        fwd_t += mm + 0.5 * e * att
        fwd_e += mm + e * att
        bwd += (mm if i == 0 else 2 * mm) + 0.5 * e * (4 * h + 4 * h * d)
    assert mod.flops(cfg, n, e) == {"train_step": pytest.approx(fwd_t + bwd),
                                    "predict": pytest.approx(2 * fwd_e)}


def test_kernel_calls_match_the_launch_arithmetic():
    """A RevGAT step 2 + 2·(L−2)·G K5 and 2 + (L−2)·G K6, an evaluation
    (1 + iters)·(2 + (L−2)·G) K5 (the launch arithmetic of the port's
    bring-up gate)."""
    class G:
        num_nodes_padded, n_edge = 256, 1000
    g = harness.resolve_cell("revgat5-arxiv-csc")
    calls = g.config_mod.kernel_calls(g.config, G)
    assert {k: len(v) for k, v in calls["train_step"].items()} == {"K5": 14, "K6": 8}
    assert {k: len(v) for k, v in calls["predict"].items()} == {"K5": 16}
    assert sorted({s["p"] for s in calls["predict"]["K5"]}) == [48, 392, 776]
