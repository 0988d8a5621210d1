"""Score a DeeperGCN ogbn-arxiv checkpoint (counterpart of
`examples/ogbn_arxiv/test.py`): load it, run full-graph inference, report
the accuracy of each split and the card's peak memory.

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_arxiv_test --synthetic \\
        --pretrained_model <exp>/ckpt [the training run's data and model flags]

The flags are the training app's (`apps/ogbn_arxiv.py`); the data and the
model must be given as they were for training. A checkpoint of a spatial
run carries the single-process model's names, so it scores here as it is;
with ``--spatial N`` it is scored on N ranks over the training run's
partition instead, the route whose logits that run printed. A ``--tp`` run's
checkpoint holds its unsharded parameters and scores in one process (the
model whose logits that run printed), ``--spatial`` and ``--tp`` being read
as the training run's flags only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.profiling import device_memory_stats
from .ogbn_arxiv import build_model, get_args, load_data, predict, split_accuracies
from .spatial_common import run_spatial


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the accuracies by split and the checkpoint's metadata."""
    args = get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    g, labels, splits, in_dim = load_data(args, np.random.default_rng(args.seed))
    if args.spatial > 1 and args.tp == 1:
        n = g.n_node
        out = run_spatial(args, "ogbn_arxiv", g.senders[:g.n_edge].numpy(),
                          g.receivers[:g.n_edge].numpy(), g.x[:n].numpy(), labels, splits,
                          in_dim, n, load=args.pretrained_model)
        accs = next(iter(out["evals"].values()))
        for k, v in accs.items():
            print(f"{k} acc: {v:.4f}", flush=True)
        return {"accs": accs, "meta": out["meta"]}
    model = build_model(args, in_dim).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    accs = split_accuracies(predict(model, g.to(dev)).cpu().numpy(), labels, splits)
    for k, v in accs.items():
        print(f"{k} acc: {v:.4f}", flush=True)
    mem = device_memory_stats(dev)
    if mem["peak_bytes_in_use"]:
        print(f"peak device memory: {mem['peak_bytes_in_use'] / 2**20:.1f} MiB "
              f"({torch.cuda.get_device_name(dev)})", flush=True)
    return {"accs": accs, "meta": meta}


if __name__ == "__main__":
    main()
