"""Score a DeeperGCN ogbg-ppa checkpoint (counterpart of
`examples/ogbg_ppa/test.py`): load it, classify every test graph, report the
accuracy and the card's peak memory.

    python -m deep_gcns_torch_tpu_torch.apps.ogbg_ppa_test --synthetic \\
        --pretrained_model <exp>/ckpt_best [the training run's data and model flags]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.metrics import accuracy
from ..utils.profiling import device_memory_stats
from .ogbg_mol import make_batcher, predict_all
from .ogbg_ppa import build_model, get_args, label, load_ppa, predict


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the accuracy, the checkpoint's metadata and the peak device
    memory in bytes (None on the CPU)."""
    args = get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    train_gs, test_gs = load_ppa(args, np.random.default_rng(args.seed))
    make_batch = make_batcher(args.batch_size, train_gs + test_gs, label)
    model = build_model(args).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    acc = accuracy(*predict_all(model, test_gs, args.batch_size, make_batch, dev, predict))
    print(f"test acc: {acc:.4f} ({len(test_gs)} graphs)", flush=True)
    peak = device_memory_stats(dev)["peak_bytes_in_use"]
    if peak:
        print(f"peak device memory: {peak / 2**20:.1f} MiB ({torch.cuda.get_device_name(dev)})",
              flush=True)
    return {"acc": acc, "meta": meta, "peak_bytes": peak}


if __name__ == "__main__":
    main()
