"""Score a DeeperGCN + LinkPredictor ogbl-collab checkpoint (counterpart of
`examples/ogbl_collab/test.py`): load it, score the held-out positive edges
against the training run's evaluation negatives, report Hits@K and the
card's peak memory.

    python -m deep_gcns_torch_tpu_torch.apps.ogbl_collab_test --synthetic \\
        --pretrained_model <exp>/ckpt_best [the training run's data and model flags]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.profiling import device_memory_stats
from .ogbl_collab import build_models, eval_negatives, get_args, hits, load_data


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns Hits@K, the checkpoint's metadata and the peak device memory
    in bytes (None on the CPU)."""
    args = get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    g, _, val_pos, n, in_dim = load_data(args, rng)
    val_neg = eval_negatives(rng, n, len(val_pos[0]))
    models = build_models(args, in_dim).to(dev)
    meta = load_ckpt(args.pretrained_model, model=models)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    h = hits(args, models, g.to(dev), val_pos, val_neg, dev)
    print(f"valid Hits@{args.hits_k}: {h:.4f} ({len(val_pos[0])} positive edges)", flush=True)
    peak = device_memory_stats(dev)["peak_bytes_in_use"]
    if peak:
        print(f"peak device memory: {peak / 2**20:.1f} MiB ({torch.cuda.get_device_name(dev)})",
              flush=True)
    return {"hits": h, "meta": meta, "peak_bytes": peak}


if __name__ == "__main__":
    main()
