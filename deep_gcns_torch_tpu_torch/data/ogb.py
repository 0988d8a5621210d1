"""OGB node datasets from a local cache (counterpart of
`deep_gcns_torch_tpu/data/ogb.py`).

There is no network, so nothing is downloaded: `load_ogb_node` reads
`{root}/{name with - as _}.npz` in the JAX package's schema (x, labels,
senders, receivers, edge_attr, split_train/valid/test, num_tasks), and
without it raises the JAX loader's `FileNotFoundError`, which tells the
caller to pass ``--synthetic`` or place the cache. (The JAX loader's `ogb`
package branch, a download, is not carried over.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class NodeDataset:
    name: str
    x: Optional[np.ndarray]          # node features
    labels: np.ndarray               # [N] int or [N, T] float
    senders: np.ndarray
    receivers: np.ndarray
    edge_attr: Optional[np.ndarray]
    splits: Dict[str, np.ndarray]    # train/valid/test node index arrays
    num_tasks: int


def load_ogb_node(name: str, root: str = "data/") -> NodeDataset:
    """Load `{root}/{name}.npz`, the preprocessed cache."""
    path = os.path.join(root, name.replace("-", "_") + ".npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=True) as z:
            return NodeDataset(
                name=name,
                x=z["x"] if "x" in z else None,
                labels=z["labels"],
                senders=z["senders"],
                receivers=z["receivers"],
                edge_attr=z["edge_attr"] if "edge_attr" in z else None,
                splits={k: z[f"split_{k}"] for k in ("train", "valid", "test")},
                num_tasks=int(z["num_tasks"]),
            )
    raise FileNotFoundError(
        f"No local cache at {path} and the `ogb` package is unavailable "
        f"(no network egress). Run with --synthetic, or place a preprocessed "
        f"npz cache at {path}.")


def extract_node_features_from_edges(senders, receivers, edge_attr, num_nodes,
                                     aggr: str = "add") -> np.ndarray:
    """Proteins: node features = the sum (or mean) of the incoming edges'
    features (`examples/ogb/ogbn_proteins/dataset.py:68-85`), summed in
    float32 in edge order as the JAX package does."""
    out = np.zeros((num_nodes, edge_attr.shape[1]), np.float32)
    np.add.at(out, receivers, edge_attr)
    if aggr == "mean":
        cnt = np.bincount(receivers, minlength=num_nodes).reshape(-1, 1)
        out = out / np.maximum(cnt, 1)
    return out
