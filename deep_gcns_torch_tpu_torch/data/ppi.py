"""PPI dataset ingestion (the port's own copy of
`deep_gcns_torch_tpu/data/ppi.py`, numpy and json only).

The reference consumes PPI through PyG's dataset class
(`examples/ppi/main.py:5,120-142`), which reads the GraphSAGE raw layout:

    {split}_graph.json      networkx node_link JSON of the split's union graph
    {split}_feats.npy       [N, 50] float node features
    {split}_labels.npy      [N, 121] multi-hot labels
    {split}_graph_id.npy    [N] int graph id per node (20 train / 2 valid / 2 test)

with split ∈ {train, valid, test}.  `convert_ppi_raw` parses that layout with
numpy + json only (no networkx/torch) into this framework's `ppi.npz` cache: per
split, a list of per-graph dicts (x, senders, receivers, y) — the shape
`apps/ppi.py::load_ppi` consumes.  Run it once on a local copy:

    python -m deep_gcns_torch_tpu_torch.data.ppi /path/to/ppi_raw data/ppi.npz
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


def _split_graphs(edges: np.ndarray, feats: np.ndarray, labels: np.ndarray,
                  graph_id: np.ndarray) -> List[dict]:
    """Split the union graph into per-graph dicts with local node ids."""
    out = []
    for gid in np.unique(graph_id):
        nodes = np.flatnonzero(graph_id == gid)
        lo, hi = nodes.min(), nodes.max()
        # GraphSAGE PPI ids are contiguous per graph; map to local [0, n)
        local = np.full(hi - lo + 1, -1, np.int64)
        local[nodes - lo] = np.arange(len(nodes))
        m = (edges[:, 0] >= lo) & (edges[:, 0] <= hi) & \
            (edges[:, 1] >= lo) & (edges[:, 1] <= hi)
        e = edges[m]
        s = local[e[:, 0] - lo]
        r = local[e[:, 1] - lo]
        keep = (s >= 0) & (r >= 0)
        out.append(dict(x=feats[nodes].astype(np.float32),
                        senders=s[keep].astype(np.int64),
                        receivers=r[keep].astype(np.int64),
                        y=labels[nodes].astype(np.float32)))
    return out


def load_ppi_raw(raw_dir: str) -> Dict[str, List[dict]]:
    """Parse the GraphSAGE raw layout into {split: [graph dicts]}."""
    splits = {}
    for split in ("train", "valid", "test"):
        gpath = os.path.join(raw_dir, f"{split}_graph.json")
        if not os.path.exists(gpath):
            raise FileNotFoundError(f"missing {gpath} (GraphSAGE PPI layout)")
        with open(gpath) as f:
            gj = json.load(f)
        # node_link JSON: undirected edges appear once; mirror them (PyG's PPI
        # emits both directions via to_undirected)
        e = np.asarray([[l["source"], l["target"]] for l in gj["links"]],
                       np.int64).reshape(-1, 2)
        e = np.concatenate([e, e[:, ::-1]], 0)
        e = np.unique(e, axis=0)
        feats = np.load(os.path.join(raw_dir, f"{split}_feats.npy"))
        labels = np.load(os.path.join(raw_dir, f"{split}_labels.npy"))
        gid = np.load(os.path.join(raw_dir, f"{split}_graph_id.npy"))
        splits[split] = _split_graphs(e, feats, labels, gid)
    return splits


def convert_ppi_raw(raw_dir: str, out_path: str) -> str:
    """Raw GraphSAGE PPI → `ppi.npz` cache (object arrays of per-graph dicts)."""
    splits = load_ppi_raw(raw_dir)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path,
             train=np.asarray(splits["train"], dtype=object),
             valid=np.asarray(splits["valid"], dtype=object),
             test=np.asarray(splits["test"], dtype=object))
    return out_path


if __name__ == "__main__":
    import sys

    raw, out = sys.argv[1], sys.argv[2]
    print(convert_ppi_raw(raw, out))
    z = np.load(out, allow_pickle=True)
    print({k: len(z[k]) for k in ("train", "valid", "test")})
