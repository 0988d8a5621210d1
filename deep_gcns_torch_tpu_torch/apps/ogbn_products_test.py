"""Score a DeeperGCN ogbn-products checkpoint (counterpart of
`examples/ogbn_products/test.py`): load it, predict the graph through the
training run's fixed evaluation partition, report the accuracy of each split
and the card's peak memory.

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_products_test --synthetic \\
        --pretrained_model <exp>/ckpt_best [the training run's data and model flags]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.profiling import device_memory_stats
from .ogbn_products import build_model, eval_partitioned, get_args, load_data, split_accuracies


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Score on ``--seed``'s data; returns what `score` returns."""
    args = get_args(argv)
    return score(args, load_data(args, np.random.default_rng(args.seed)))


def score(args, data) -> dict:
    """The checkpoint of ``--pretrained_model`` on ``data`` (`load_data`'s
    tuple): the accuracies by split, the checkpoint's metadata and the peak
    device memory in bytes (None on the CPU)."""
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    x, senders, receivers, labels, splits, in_dim, n = data
    model = build_model(args, in_dim).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    accs = split_accuracies(eval_partitioned(args, model, x, senders, receivers, n, dev),
                            labels, splits)
    for k, v in accs.items():
        print(f"{k} acc: {v:.4f}", flush=True)
    peak = device_memory_stats(dev)["peak_bytes_in_use"]
    if peak:
        print(f"peak device memory: {peak / 2**20:.1f} MiB ({torch.cuda.get_device_name(dev)})",
              flush=True)
    return {"accs": accs, "meta": meta, "peak_bytes": peak}


if __name__ == "__main__":
    main()
