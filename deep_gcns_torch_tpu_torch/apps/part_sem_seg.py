"""DeepGCN on PartNet: part semantic segmentation per category, on the dense
path (counterpart of `examples/part_sem_seg/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.part_sem_seg --synthetic \\
        [--epochs E] [--device cuda|cpu] [--save_ckpt]
    python -m deep_gcns_torch_tpu_torch.apps.part_sem_seg --data_dir <partnet> --category Bed

The defaults are the JAX app's: `DenseDeepGCN` of 9 blocks (8 res blocks of
EdgeConv at 64 channels, k = 9, dilation 1 + i), batch norm, 10 part
classes, 1,024 points a shape in batches of 8, dropout 0.3; cross entropy,
``--optimizer`` (Adam) at 5e-3; each training batch is scaled, shifted and
rotated about y (`main.py:81-82`). Each epoch scores the validation shapes'
mean part IoU and shape mIoU (`main.py:102-148`); with ``--save_ckpt`` a new
best part IoU writes `{exp}/ckpt_best` and the last epoch `{exp}/ckpt_last`,
which `apps/part_sem_seg_eval.py` scores.

Data: ``--synthetic`` draws the JAX app's shapes (48 train, 16 val, 16
test: Gaussian clouds labelled by angular sector); PartNet's sem_seg_h5
files (``--data_dir``) are not in the repository.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data import pointcloud as pc
from ..device import resolve_device
from ..models import DeepGCNConfig, DenseDeepGCN
from ..utils.ckpt import save_ckpt
from ..utils.metrics import part_seg_miou
from . import sem_seg_dense as dense
from .common import EpochTimer, base_parser, make_optimizer, open_experiment, report

train_step, predict = dense.train_step, dense.predict
PHASES = ("train", "val", "test")


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeepGCN PartNet part segmentation (PyTorch/CUDA)")
    p.add_argument("--data_dir", type=str, default="",
                   help="PartNet root containing sem_seg_h5/{category}-{level}/")
    p.add_argument("--category", type=str, default="Bed")
    p.add_argument("--level", type=int, default=3)
    dense.add_point_flags(p, k=9, n_blocks=9, in_channels=3, n_classes=10, num_points=1024,
                          batch_size=8)
    # the evaluation script's flags share this surface
    p.add_argument("--res_dir", type=str, default="",
                   help="part_sem_seg_eval: directory for the coloured .obj exports")
    p.add_argument("--max_export", type=int, default=8,
                   help="part_sem_seg_eval: most shapes to export")
    p.add_argument("--eval_phase", type=str, default="test", choices=["val", "test"],
                   help="part_sem_seg_eval: the phase to score (val: the training run's)")
    p.set_defaults(epochs=200, lr=5e-3, dropout=0.3)
    return p.parse_args(argv)


def build_model(args, generator: Optional[torch.Generator] = None) -> DenseDeepGCN:
    return DenseDeepGCN(DeepGCNConfig(
        in_channels=args.in_channels, n_classes=args.n_classes, n_filters=args.n_filters,
        n_blocks=args.n_blocks, conv=args.conv, norm=args.norm, block=args.block,
        dropout=args.dropout, k=args.k, knn_method=args.knn_method,
        compute_dtype=args.compute_dtype or None), generator=generator)


def load_phase(args, rng: np.random.Generator, phase: str):
    """(points [S, N, 3], labels [S, N]) of a phase: synthetic shapes, or the
    category's h5 files with each shape sampled to ``--num_points``."""
    if args.synthetic or not args.data_dir:
        if not args.synthetic:
            raise FileNotFoundError("PartNet h5 data needs --data_dir (download requires "
                                    "application); pass --synthetic for a stand-in")
        n = {"train": 48, "val": 16, "test": 16}[phase]
        return pc.synthetic_partnet(rng, n, args.num_points, args.n_classes)
    pts, lab = pc.load_partnet(args.data_dir, args.category, args.level, phase)
    if pts.shape[1] != args.num_points:
        idx = rng.choice(pts.shape[1], args.num_points, replace=pts.shape[1] < args.num_points)
        pts, lab = pts[:, idx], lab[:, idx]
    n_cls = int(lab.max()) + 1
    if n_cls > args.n_classes:
        raise ValueError(f"data has {n_cls} part classes; pass --n_classes {n_cls}")
    return pts.astype(np.float32), lab.astype(np.int64)


def load_phases(args, rng: np.random.Generator, upto: str):
    """The phases from train up to ``upto``, drawn in the training run's
    order (synthetic shapes depend on it)."""
    return [load_phase(args, rng, ph) for ph in PHASES[:PHASES.index(upto) + 1]]


def predict_all(model: DenseDeepGCN, args, xs: np.ndarray, dev: torch.device) -> np.ndarray:
    """Class ids [S, N] of every shape (a trailing partial batch padded and
    trimmed)."""
    n, bs = len(xs), min(args.batch_size, len(xs))
    pad = (-n) % bs
    xp = np.concatenate([xs, xs[-1:].repeat(pad, 0)]) if pad else xs
    preds = [predict(model, torch.from_numpy(xp[lo:lo + bs]).to(dev)).cpu().numpy()
             for lo in range(0, len(xp), bs)]
    return np.concatenate(preds)[:n]


def evaluate(model: DenseDeepGCN, args, xs: np.ndarray, ys: np.ndarray, dev: torch.device):
    """(mean part IoU, shape mIoU) over every shape of ``xs``."""
    return part_seg_miou(predict_all(model, args, xs, dev), ys, args.n_classes)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the best part IoU, every epoch's loss, part IoU and
    shape mIoU, and the experiment directory (None without ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    (tr_x, tr_y), (va_x, va_y) = load_phases(args, rng, "val")
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args, model.parameters())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "part_sem_seg")
    timer, best, losses, part_ious, shape_mious = EpochTimer(), 0.0, [], [], []
    for epoch in range(args.epochs):
        ep = []
        for x, y in pc.batch_iter(rng, tr_x, tr_y, args.batch_size, augment=True):
            x = pc.rotate_point_cloud(rng, x)
            ep.append(train_step(model, opt, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev), gen))
        loss = float(torch.stack(ep).mean())
        part_iou, shape_miou = evaluate(model, args, va_x, va_y, dev)
        losses.append(loss)
        part_ious.append(part_iou)
        shape_mious.append(shape_miou)
        if part_iou > best:
            best = part_iou
            if exp is not None:
                save_ckpt(f"{exp}/ckpt_best", model=model, epoch=epoch, best_value=best)
        report(logger, f"epoch {epoch} loss {loss:.4f} part-IoU {part_iou:.4f} "
                       f"shape-mIoU {shape_miou:.4f} ({timer.lap():.1f}s)")
        if scalars is not None:
            scalars.log(epoch, loss=loss, part_iou=part_iou, shape_miou=shape_miou)
    if exp is not None:
        save_ckpt(f"{exp}/ckpt_last", model=model, epoch=args.epochs - 1, best_value=best)
    report(logger, f"best part-IoU {best:.4f}")
    return {"best": best, "losses": losses, "part_iou": part_ious,
            "shape_miou": shape_mious, "exp": exp}


if __name__ == "__main__":
    main()
