"""OGB helpers (counterpart of `deep_gcns_torch_tpu/data/ogb.py:72-81`).

Only the proteins node-feature extraction is ported; loading the OGB
datasets waits until their files are in the repository (there is no
network to download them)."""

from __future__ import annotations

import numpy as np


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
