"""Traffic generation: the inputs of a cell drawn from ``--seed``.

The generators are frozen copies, so that no later change to the program can
move the yardstick. ``powerlaw_community`` is the hub-heavy community graph of
the port's `data/synthetic.powerlaw_community_edges` (the same draws in the
same order). A traffic file names its generator and parameters; `make_inputs`
returns the raw directed edges and the node data, which the harness hands to
the program's builders and the reference alike.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def powerlaw_community_edges(rng: np.random.Generator, n: int, avg_degree: int,
                             n_comm: int = 256, homophily: float = 0.9,
                             alpha: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """n·avg_degree directed edges: senders drawn by a shuffled power law of
    exponent ``alpha``; a receiver stays in its sender's community with
    probability ``homophily`` and is uniform otherwise. Ids arrive shuffled."""
    e = n * avg_degree
    comm = rng.integers(0, n_comm, n)
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** alpha
    rng.shuffle(w)
    s = rng.choice(n, e, p=w / w.sum())
    r = rng.integers(0, n, e)
    same = rng.random(e) < homophily
    sel = np.flatnonzero(same)
    cs = comm[s[sel]]
    edges = sel[np.argsort(cs, kind="stable")]
    e_lo = np.searchsorted(np.sort(cs), np.arange(n_comm + 1))
    nodes = np.argsort(comm, kind="stable")
    n_lo = np.searchsorted(comm[nodes], np.arange(n_comm + 1))
    for k in range(n_comm):
        m = edges[e_lo[k]:e_lo[k + 1]]
        idx = nodes[n_lo[k]:n_lo[k + 1]]
        if m.size and idx.size:
            r[m] = idx[rng.integers(0, idx.size, m.size)]
    return s.astype(np.int64), r.astype(np.int64)


GENERATORS = {"powerlaw_community": powerlaw_community_edges}


def make_inputs(traffic: Dict, seed: int) -> Dict:
    """The cell's inputs from ``seed``: raw directed edges (``senders``,
    ``receivers``), standard-normal float32 features ``x`` [n, features],
    uniform labels in [0, classes) and random splits of the traffic's sizes
    (`train`, `valid`, `test` index arrays)."""
    rng = np.random.default_rng([int(seed), 0])
    gen = GENERATORS[traffic["generator"]]
    params = dict(traffic["params"])
    n = int(params["n"])
    s, r = gen(rng, **params)
    x = rng.standard_normal((n, int(traffic["features"])), dtype=np.float32)
    labels = rng.integers(0, int(traffic["classes"]), n)
    sizes = traffic["splits"]
    if sum(sizes.values()) != n:
        raise ValueError(f"split sizes {sizes} do not add up to {n} nodes")
    perm = rng.permutation(n)
    splits, lo = {}, 0
    for name in ("train", "valid", "test"):
        splits[name] = np.sort(perm[lo:lo + int(sizes[name])])
        lo += int(sizes[name])
    return {"n": n, "senders": s, "receivers": r, "x": x, "labels": labels, "splits": splits}


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a torch.Generator, one stream of ``seed``."""
    state = np.random.SeedSequence([int(seed), 1000 + int(stream)]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)
