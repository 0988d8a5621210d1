"""Score a PartNet checkpoint and export coloured shapes (counterpart of
`examples/part_sem_seg/eval.py`): mean part IoU and shape mIoU of one
phase's shapes (``--eval_phase``: test, or val, which reproduces the
training run's score), and per shape `{category}_{i}_pred.obj` and
`{category}_{i}_gt.obj` ('v x y z r g b' lines, which
`apps/part_sem_seg_visualize.py` reads) under ``--res_dir``.

    python -m deep_gcns_torch_tpu_torch.apps.part_sem_seg_eval --synthetic \\
        --pretrained_model <exp>/ckpt_best --res_dir <out> [the training run's flags]
"""

from __future__ import annotations

import colorsys
import os
from typing import Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..utils.ckpt import load_ckpt
from ..utils.metrics import part_seg_miou
from . import part_sem_seg as app


def class_color(c: int, n: int):
    """A distinct colour per part id (an HSV wheel)."""
    h = (c / max(n, 1)) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85 if c % 2 else 1.0, 1.0 if c % 3 else 0.7)
    return int(r * 255), int(g * 255), int(b * 255)


def write_colored_obj(path: str, pts, labels, n_classes: int) -> str:
    """'v x y z r g b' per point (reference `eval.py:95-112`)."""
    with open(path, "w") as f:
        for p, c in zip(pts, labels):
            r, g, b = class_color(int(c), n_classes)
            f.write(f"v {p[0]:f} {p[1]:f} {p[2]:f} {r} {g} {b}\n")
    return path


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"part_iou", "shape_miou", "meta", "exports"}."""
    args = app.get_args(argv)
    if not args.pretrained_model:
        raise ValueError("--pretrained_model is required")
    dev = resolve_device(args.device)
    xs, ys = app.load_phases(args, np.random.default_rng(args.seed), args.eval_phase)[-1]
    model = app.build_model(args).to(dev)
    meta = load_ckpt(args.pretrained_model, model=model)
    print(f"loaded checkpoint (epoch {meta.get('epoch')}, "
          f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    preds = app.predict_all(model, args, xs, dev)
    part_iou, shape_miou = part_seg_miou(preds, ys, args.n_classes)
    print(f"{args.category} ({args.eval_phase}): mean part IoU {part_iou:.4f}  "
          f"shape mIoU {shape_miou:.4f}  ({len(xs)} objects)", flush=True)
    res_dir = args.res_dir or "partseg_results"
    os.makedirs(res_dir, exist_ok=True)
    exports = []
    for i in range(min(len(xs), args.max_export)):
        for tag, lab in (("pred", preds[i]), ("gt", ys[i])):
            exports.append(write_colored_obj(
                os.path.join(res_dir, f"{args.category}_{i}_{tag}.obj"), xs[i], lab,
                args.n_classes))
    print(f"wrote qualitative exports to {res_dir}", flush=True)
    return {"part_iou": part_iou, "shape_miou": shape_miou, "meta": meta, "exports": exports}


if __name__ == "__main__":
    main()
