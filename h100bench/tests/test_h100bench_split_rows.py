"""gen.split_rows reads the window's K2 gather-form launches times the rows
the port's launches split on average (its `softmax_agg.split_rows`), and 0
from a program that splits none or has no such counter."""

import os
from types import SimpleNamespace

import pytest

from deep_gcns_torch_tpu_torch.ops import spmm_cuda
from h100bench import harness


def _reader():
    return harness.load_module(os.path.join(harness.HERE, "metrics", "gen.split_rows.py"))


def _ctx(k2, k2ee, epochs=10):
    return SimpleNamespace(
        counters0={"launches": {"K2": 5, "K2ee": 1, "K4": 3}},
        counters1={"launches": {"K2": 5 + k2, "K2ee": 1 + k2ee, "K4": 99}},
        per_epoch=lambda d: d / epochs)


def _counters(monkeypatch, launches, launches_ee, split_rows):
    k2 = spmm_cuda.softmax_agg
    monkeypatch.setattr(k2, "launches", launches)
    monkeypatch.setattr(k2, "launches_ee", launches_ee)
    if split_rows is None:
        monkeypatch.delattr(k2, "split_rows")
    else:
        monkeypatch.setattr(k2, "split_rows", split_rows)


def test_split_rows_per_epoch(monkeypatch):
    _counters(monkeypatch, 400, 0, 400 * 358)
    assert _reader().read(_ctx(336, 0)) == pytest.approx(358 * 33.6)
    _counters(monkeypatch, 10, 30, 3 * 20)  # ten launches split none, thirty three each
    assert _reader().read(_ctx(0, 20)) == pytest.approx(20 * 1.5 / 10)


@pytest.mark.parametrize("counters", [(400, 0, 0), (0, 0, 0), (400, 0, None)],
                         ids=["splits_none", "no_launch", "no_counter"])
def test_a_program_that_splits_nothing_reads_zero(monkeypatch, counters):
    _counters(monkeypatch, *counters)
    assert _reader().read(_ctx(336, 0)) == 0.0


def test_the_plain_version_splits_no_row():
    """On the CPU the port's wrapper runs the plain version, which splits no
    row whatever the graph's count: its launches read 0."""
    import numpy as np
    import torch

    from deep_gcns_torch_tpu_torch.graph import build_graph

    r = np.concatenate([np.full(300, 4), np.arange(50)])
    g = build_graph(None, np.zeros(r.shape[0], int), r, num_nodes=50)
    assert g.split_rows == 1
    before = spmm_cuda.softmax_agg.split_rows
    x = torch.randn(g.num_nodes_padded, 8)
    spmm_cuda.softmax_agg(x, g.senders, g.row_ptr, g.row_order, torch.tensor([0.1]), 1e-7,
                          split_rows=g.split_rows)
    assert spmm_cuda.softmax_agg.split_rows == before
