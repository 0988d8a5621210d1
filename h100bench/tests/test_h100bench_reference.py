"""The plain references against the port's CPU path on a tiny graph, and
the blocked attention aggregation against autograd of the written-out
formula."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import cells, tiny_cell
from h100bench import correct, graphgen, harness
from h100bench.reference import plain


def _graph(n=9, e=30, seed=0):
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(0, n, (e,), generator=g)
    r = torch.randint(0, n, (e,), generator=g)
    loop = torch.arange(n)
    return torch.cat([s, loop]), torch.cat([r, loop])


def test_gat_agg_matches_autograd(monkeypatch):
    monkeypatch.setattr(plain, "BLOCK_ELEMS", 16)
    send, recv = _graph(seed=1)
    keep = torch.rand(send.shape[0], generator=torch.Generator().manual_seed(2)) < 0.7
    send, recv = send[keep], recv[keep]
    el = torch.randn(9, 2, dtype=torch.float64, requires_grad=True)
    v = torch.randn(9, 2, 3, dtype=torch.float64, requires_grad=True)
    out = plain.GATAgg.apply(el, v, send, recv, 0.2)
    score = F.leaky_relu(el[send], 0.2)
    want = torch.zeros(9, 2, 3, dtype=torch.float64)
    for r in range(9):
        sel = recv == r
        if sel.any():
            a = torch.softmax(score[sel], 0)
            want = want.index_add(0, torch.tensor([r]), (a[..., None] * v[send[sel]]).sum(0,
                                                                              keepdim=True))
    torch.testing.assert_close(out, want)
    g = torch.randn(9, 2, 3, dtype=torch.float64)
    ga = torch.autograd.grad(out, [el, v], g)
    gb = torch.autograd.grad(want, [el, v], g)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b)


def test_graph_edges_symmetric_dedup_one_loop_a_node():
    inp = {"n": 4, "senders": np.array([0, 1, 2, 2, 3]), "receivers": np.array([1, 0, 2, 3, 3])}
    s, r = plain.graph_edges(inp, "cpu")
    got = sorted(zip(s.tolist(), r.tolist()))
    assert got == [(0, 0), (0, 1), (1, 0), (1, 1), (2, 2), (2, 3), (3, 2), (3, 3)]


@pytest.mark.parametrize("name", cells())
def test_reference_follows_the_port_on_the_cpu(name):
    """The warm-up of the port's CPU path agrees with the reference within the
    cell's own limits."""
    cell = tiny_cell(name)
    dev = torch.device("cpu")
    inp = graphgen.make_inputs(cell.traffic, 3)
    data = harness.build_data(cell.traffic, inp, dev, 3)
    st = harness.setup_job(cell, data, dev, 3, harness.Spans())
    ref = cell.reference.run(cell.config, harness.reference_inputs(inp, data, st), dev)
    v = correct.readings(st.record, ref, data.n)
    assert correct.judge(v, cell.limits), v
    assert len(ref["losses"]) == harness.REF_STEPS
