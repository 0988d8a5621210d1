"""Score a DeepGCN PPI checkpoint (counterpart of `examples/ppi/test.py`):
load it, report the micro-F1 on the valid and the test graphs and the
card's peak memory.

    python -m deep_gcns_torch_tpu_torch.apps.ppi_test --synthetic \\
        --pretrained_model <exp>/ckpt_best [the training run's data and model flags]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.profiling import device_memory_stats
from .ppi import build_model, evaluate, get_args, load_ppi, make_batcher


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the valid and test micro-F1, the checkpoint's metadata and the
    peak device memory in bytes (None on the CPU)."""
    args = get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    train_gs, valid_gs, test_gs = load_ppi(args, np.random.default_rng(args.seed))
    to_batch = make_batcher(args, train_gs + valid_gs + test_gs)
    model = build_model(args).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    out = {"meta": meta}
    for name, gs in (("valid", valid_gs), ("test", test_gs)):
        out[name] = evaluate(model, gs, to_batch, dev)
        print(f"{name} micro-F1: {out[name]:.4f} ({len(gs)} graphs)", flush=True)
    out["peak_bytes"] = peak = device_memory_stats(dev)["peak_bytes_in_use"]
    if peak:
        print(f"peak device memory: {peak / 2**20:.1f} MiB ({torch.cuda.get_device_name(dev)})",
              flush=True)
    return out


if __name__ == "__main__":
    main()
