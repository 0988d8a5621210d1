"""A plain version's first call in a fresh process against its second call.

Two plain versions on the CPU, K2's `softmax_agg_plain` and K7's
`win_fused_plain`, were seen in rare runs to return a first call that
differed from later ones. The cause was torch's first CPU `exp` of a
process, which the package's import now takes (`deep_gcns_torch_tpu_torch/
__init__.py`). Each case here runs in fresh Python processes; each process
calls the plain version twice on the same seeded inputs and prints a digest
of both calls, so the calls compare bit for bit within a process and across
processes.

    python tests/test_torch_plain_repeat.py --procs 50

runs every case in that many fresh processes and prints, per case, how many
first calls differed from their second call, the largest relative
difference, and how many distinct results the processes gave; the test runs
two processes a case.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_budget
from torch_budget import budget  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K2 at the CPU rehearsal's graph; K7 on a 1,024-node band with hub columns
# and on the 4,096-node band whose rows pass its list, with the drop
CASES = ("K2 rehearsal graph", "K7 1024 nodes", "K7 4096 nodes")


def _dense_band(n, long_rows):
    """A locality-banded power-law graph's forward band (window 512 with hub
    columns and rows of degree ≥ 64; or, with ``long_rows``, window 768, no
    hub rows and receivers of 700, 400 and 256 senders, with the hub columns
    of a second band attached)."""
    import dataclasses

    from deep_gcns_torch_tpu_torch.graph import attach_band, build_graph

    rng = np.random.default_rng(21)
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.8
    rng.shuffle(w)
    s = rng.choice(n, n * 8, p=w / w.sum())
    r = np.clip(s + rng.integers(-200, 201, n * 8), 0, n - 1)
    if not long_rows:
        return attach_band(build_graph(None, s, r, num_nodes=n), window=512, hubs=64).band.fwd
    hub_band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=64).band.fwd
    s = np.concatenate([s, np.arange(0, 700), np.arange(100, 500), np.arange(500, 756)])
    r = np.concatenate([r, np.full(700, 5), np.full(400, 300), np.full(256, 700)])
    band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=None).band.fwd
    return dataclasses.replace(band, hub_ids=hub_band.hub_ids, a_hub=hub_band.a_hub)


def _case_call(case):
    """The seeded inputs of ``case`` and a function that calls its plain
    version on them, float32."""
    from deep_gcns_torch_tpu_torch.ops import band as tband
    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd
    from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp

    if case.startswith("K2"):
        from deep_gcns_torch_tpu_torch.data.synthetic import random_node_graph

        g, _ = random_node_graph(np.random.default_rng(0), 2000, 14, 128, self_loops=True)
        t = torch.tensor([0.1])
        return lambda: tsp.softmax_agg_plain(g.x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
    n = int(case.split()[1])
    band = _dense_band(n, long_rows=n == 4096)
    n_pad = band.a.shape[0]
    gen = torch.Generator().manual_seed(7)
    feat = torch.randn(n_pad, 3 * 128, generator=gen)
    el = torch.randn(n_pad, 3, generator=gen) * 2
    er = torch.randn(n_pad, 3, generator=gen) * 2
    m_other = torch.full((n_pad, 3), tgd.NEG)
    m_other[::5] = 3.0
    spec = tband.DropSpec(k0=-99, k1=31337, thresh=tband.drop_thresh(0.3))
    return lambda: tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec)


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _child(case):
    call = _case_call(case)
    a, b = call(), call()
    rel = max(float(((x - y).abs() / y.abs().clamp_min(1e-30)).max()) for x, y in zip(a, b))
    print(json.dumps({"case": case, "first": _digest(a), "second": _digest(b),
                      "max_rel_diff": rel, "threads": torch.get_num_threads()}))


def run_case(case, procs):
    """The results of ``procs`` fresh processes, each calling the plain
    version of ``case`` twice."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = []
    for _ in range(procs):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", case],
                             capture_output=True, text=True, timeout=torch_budget.SUBPROCESS_S,
                             check=True, env=env)
        out.append(json.loads(run.stdout.strip().splitlines()[-1]))
    return out


# a fresh process that imports the package, then takes exp of a large
# tensor twice on the CPU and prints how many values the calls disagree on
_FIRST_EXP = """
import torch
import deep_gcns_torch_tpu_torch
torch.manual_seed(0)
x = torch.randn(300_000) * 5
a = torch.exp(x)
print(int((a != torch.exp(x)).sum()))
"""


def test_first_exp_after_import_equals_second():
    """torch's first CPU exp of a process computed one worker thread's share
    with wrong values in a few fresh processes in a hundred; importing the
    package takes that first call on the calling thread, so in 16 fresh
    processes the first exp after the import equals the second bit for
    bit."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_EXP], stdout=subprocess.PIPE,
                              text=True, env=env) for _ in range(16)]
    outs = [p.communicate(timeout=torch_budget.SUBPROCESS_S)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert [int(o.strip().splitlines()[-1]) for o in outs] == [0] * 16


@pytest.mark.parametrize("case", CASES)
def test_first_call_equals_second_call(case):
    """In two fresh processes the plain version's first call equals its
    second call bit for bit, and both processes give the same result."""
    res = run_case(case, 2)
    assert all(r["first"] == r["second"] for r in res), res
    assert len({r["first"] for r in res}) == 1, res


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        _child(sys.argv[2])
        sys.exit(0)
    procs = int(sys.argv[sys.argv.index("--procs") + 1]) if "--procs" in sys.argv else 50
    for case in CASES:
        res = run_case(case, procs)
        print(json.dumps({"case": case, "procs": procs,
                          "first_differs_from_second": sum(r["first"] != r["second"]
                                                           for r in res),
                          "distinct_results": len({r["first"] for r in res} |
                                                  {r["second"] for r in res}),
                          "max_rel_diff": max(r["max_rel_diff"] for r in res),
                          "threads": sorted({r["threads"] for r in res})}), flush=True)
