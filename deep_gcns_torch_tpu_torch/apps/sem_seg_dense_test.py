"""Score a DenseDeepGCN S3DIS checkpoint (counterpart of
`examples/sem_seg_dense/test.py`): the training run's mIoU over the classes
present, which equals the run's printed best for `ckpt_best`, and the
area-level protocol of `test.py:32-61`: intersection and union accumulated
over every test block (a trailing partial batch padded and trimmed), a class
with no point scored 1, the per-class IoUs and their mean.

    python -m deep_gcns_torch_tpu_torch.apps.sem_seg_dense_test --synthetic \\
        --pretrained_model <exp>/ckpt_best [the training run's data and model flags]

With ``--synthetic`` the blocks are drawn as the training run draws them
(train, then test, from ``--seed``), so the scored blocks are the run's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from . import sem_seg_dense as app


def area_iou(model: torch.nn.Module, args, xs: np.ndarray, ys: np.ndarray,
             dev: torch.device, predict_fn: Callable) -> np.ndarray:
    """Per-class IoU over all of ``xs`` (`test.py:32-61`)."""
    inter = np.zeros(args.n_classes, np.float64)
    union = np.zeros(args.n_classes, np.float64)
    n, bs = len(xs), min(args.batch_size, len(xs))
    pad = (-n) % bs
    xp = np.concatenate([xs, xs[-1:].repeat(pad, 0)]) if pad else xs
    for lo in range(0, n, bs):
        pred = predict_fn(model, torch.from_numpy(xp[lo:lo + bs]).to(dev)).cpu().numpy()
        hi = min(lo + bs, n)
        pred, gt = pred.reshape(bs, -1)[: hi - lo], ys[lo:hi].reshape(hi - lo, -1)
        for cl in range(args.n_classes):
            inter[cl] += np.logical_and(pred == cl, gt == cl).sum()
            union[cl] += np.logical_or(pred == cl, gt == cl).sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = inter / union
    ious[np.isnan(ious)] = 1.0
    return ious


def score(app_mod, argv: Optional[Sequence[str]], name: str) -> dict:
    """Load ``--pretrained_model`` into the app's model and score the test
    blocks both ways; returns {"miou", "area_miou", "ious", "meta"}."""
    args = app_mod.get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    _, (te_x, te_y) = app_mod.load_data(args, np.random.default_rng(args.seed))
    model = app_mod.build_model(args).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    miou = app_mod.evaluate(model, args, te_x, te_y, dev)
    ious = area_iou(model, args, te_x, te_y, dev, app_mod.predict)
    for cl, v in enumerate(ious):
        print(f"IoU class {cl}: {v:.4f}", flush=True)
    print(f"{name}: mIoU {miou:.4f} (the training protocol), area mIoU over "
          f"{len(te_x)} blocks {float(ious.mean()):.4f}", flush=True)
    return {"miou": miou, "area_miou": float(ious.mean()), "ious": ious, "meta": meta}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return score(app, argv, "sem_seg_dense")


if __name__ == "__main__":
    main()
