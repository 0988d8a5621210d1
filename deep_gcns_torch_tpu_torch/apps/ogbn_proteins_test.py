"""Multi-view inference of a RevGCN ogbn-proteins checkpoint (counterpart of
`examples/ogb_eff/ogbn_proteins/test.py`): load it, predict on
``--num_evals`` independent random partitions into ``--eval_parts``
clusters, average the predictions, and report the ROC-AUC of each split and
the card's peak memory.

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_proteins_test --synthetic \\
        --pretrained_model <exp>/ckpt_best --num_evals 3 --eval_parts 5 \\
        [the training run's data and model flags]

The flags are those of `apps/ogbn_proteins_rev.py`; the data and the model
must be given as they were for training. A rolling checkpoint of
``--save_ckpt`` is the prefix `<exp>/ckpt/<epoch>/ckpt`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data.partition import generate_sub_graphs
from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.metrics import roc_auc
from ..utils.profiling import device_memory_stats
from .ogbn_proteins_rev import build_model, get_args
from .proteins_common import load_proteins, multi_view_predict


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the ROC-AUC by split, the checkpoint's metadata and the peak
    device memory in bytes (None on the CPU)."""
    args = get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    data = load_proteins(args, np.random.default_rng(args.seed))
    n, labels = data["num_nodes"], data["labels"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(args).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')})", flush=True)
    node_pad = ((n // args.eval_parts + 1023) // 256 + 1) * 256

    def clusters(parts, k):
        return generate_sub_graphs(data["senders"], data["receivers"], parts, k,
                                   edge_attr=data["edge_attr"],
                                   node_feats=[data["species"], data["node_feats"]],
                                   node_pad=node_pad)

    pred = multi_view_predict(model, data, dev, args.eval_parts, args.num_evals, clusters)
    aucs = {k: roc_auc(pred[idx], labels[idx]) for k, idx in data["splits"].items()}
    for k, v in aucs.items():
        print(f"{k} ROC-AUC: {v:.4f}", flush=True)
    peak = device_memory_stats(dev)["peak_bytes_in_use"]
    if peak:
        print(f"peak device memory: {peak / 2**20:.1f} MiB ({torch.cuda.get_device_name(dev)})",
              flush=True)
    return {"aucs": aucs, "meta": meta, "peak_bytes": peak}


if __name__ == "__main__":
    main()
