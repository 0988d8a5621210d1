"""Score a DeeperGCN ogbg-mol checkpoint (counterpart of
`examples/ogbg_mol/test.py`): load it, score every test molecule, report
ROC-AUC (one task) or average precision and the card's peak memory.

    python -m deep_gcns_torch_tpu_torch.apps.ogbg_mol_test --synthetic \\
        --pretrained_model <exp>/ckpt_best [the training run's data and model flags]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.profiling import device_memory_stats
from .ogbg_mol import build_model, get_args, load_mol, make_batcher, predict_all, score


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the score, the checkpoint's metadata and the peak device
    memory in bytes (None on the CPU)."""
    args = get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    train_gs, test_gs = load_mol(args, np.random.default_rng(args.seed))
    make_batch = make_batcher(args.batch_size, train_gs + test_gs)
    model = build_model(args).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    m = score(args, *predict_all(model, test_gs, args.batch_size, make_batch, dev))
    name = "ROC-AUC" if args.num_tasks == 1 else "AP"
    print(f"test {name}: {m:.4f} ({len(test_gs)} graphs)", flush=True)
    peak = device_memory_stats(dev)["peak_bytes_in_use"]
    if peak:
        print(f"peak device memory: {peak / 2**20:.1f} MiB ({torch.cuda.get_device_name(dev)})",
              flush=True)
    return {"score": m, "meta": meta, "peak_bytes": peak}


if __name__ == "__main__":
    main()
