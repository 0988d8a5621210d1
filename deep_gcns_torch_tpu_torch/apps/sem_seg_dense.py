"""DenseDeepGCN on S3DIS: semantic segmentation on the dense [B, N, C] path
(counterpart of `examples/sem_seg_dense/train.py`).

    python -m deep_gcns_torch_tpu_torch.apps.sem_seg_dense --synthetic \\
        [--epochs E] [--device cuda|cpu] [--save_ckpt]

The defaults are the JAX app's ResGCN-28: 27 res blocks of EdgeConv at 64
channels, k = 16, block i at dilation 1 + i, batch norm, 13 classes, blocks
of B = 8 × N = 4,096 points with 9 input channels, float32 (``--compute_dtype
bfloat16`` runs the edge path in bf16 with float32 accumulation), dropout
0.3, Adam at 1e-3 halved every 50 epochs (a staircase over the updates).
The gathers of the 64-channel blocks run K1 in their backward.

Data: ``--synthetic`` draws the JAX app's blocks from ``--seed`` (48 train,
then 16 test blocks; label = a function of the octant); the real S3DIS h5
blocks (`data/pointcloud.load_s3dis`) are not in the repository. Each epoch
scores the mIoU over the classes present in the test blocks
(`utils.metrics.IoUAccumulator`); with ``--save_ckpt`` a new best writes
`{exp}/ckpt_best`, which `apps/sem_seg_dense_test.py` scores.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import pointcloud as pc
from ..device import resolve_device
from ..models import DeepGCNConfig, DenseDeepGCN
from ..utils.ckpt import save_ckpt
from ..utils.loss import cross_entropy
from ..utils.metrics import IoUAccumulator
from .common import EpochTimer, base_parser, open_experiment, report


def add_point_flags(p, *, k: int, n_blocks: int, in_channels: int, n_classes: int,
                    num_points: int, batch_size: int):
    """The point-cloud apps' model and data flags (`examples/*/train.py`)."""
    p.add_argument("--k", type=int, default=k)
    p.add_argument("--knn_method", type=str, default="exact", choices=["exact", "approx"],
                   help="approx = kNN over a 1/d candidate subsample (ops/knn.py)")
    p.add_argument("--compute_dtype", type=str, default="",
                   help="e.g. bfloat16: bf16 conv compute, f32 accumulation")
    p.add_argument("--block", type=str, default="res")
    p.add_argument("--conv", type=str, default="edge")
    p.add_argument("--norm", type=str, default="batch")
    p.add_argument("--n_blocks", type=int, default=n_blocks)
    p.add_argument("--n_filters", type=int, default=64)
    p.add_argument("--in_channels", type=int, default=in_channels)
    p.add_argument("--n_classes", type=int, default=n_classes)
    p.add_argument("--num_points", type=int, default=num_points)
    p.add_argument("--batch_size", type=int, default=batch_size)
    return p


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DenseDeepGCN S3DIS semantic segmentation (PyTorch/CUDA)")
    add_point_flags(p, k=16, n_blocks=28, in_channels=9, n_classes=13, num_points=4096,
                    batch_size=8)
    p.add_argument("--test_area", type=int, default=5)
    p.add_argument("--stochastic", action="store_true", default=False)
    p.add_argument("--epsilon", type=float, default=0.2)
    p.add_argument("--lr_decay_epochs", type=int, default=50)
    p.add_argument("--lr_decay_rate", type=float, default=0.5)
    p.set_defaults(epochs=100, lr=1e-3, dropout=0.3)
    return p.parse_args(argv)


def build_model(args, generator: Optional[torch.Generator] = None) -> DenseDeepGCN:
    return DenseDeepGCN(DeepGCNConfig(
        in_channels=args.in_channels, n_classes=args.n_classes, n_filters=args.n_filters,
        n_blocks=args.n_blocks, conv=args.conv, norm=args.norm, block=args.block,
        dropout=args.dropout, k=args.k, knn_method=args.knn_method,
        compute_dtype=args.compute_dtype or None, stochastic=args.stochastic,
        epsilon=args.epsilon), generator=generator)


def load_split(args, rng: np.random.Generator, split: str):
    """(points [S, N, C], labels [S, N]) of a split: the synthetic blocks
    (48 train, 16 test, drawn in that order), or the S3DIS h5 blocks."""
    if args.synthetic:
        n = 48 if split == "train" else 16
        return pc.synthetic_s3dis(rng, n, args.num_points, args.n_classes)
    return pc.load_s3dis(args.data_root, args.test_area, split)


def load_data(args, rng: np.random.Generator):
    """(train, test) pairs, drawn in the training run's order."""
    return load_split(args, rng, "train"), load_split(args, rng, "test")


def make_optimizer(args, model: torch.nn.Module, steps_per_epoch: int):
    """Adam at ``--lr``, times ``--lr_decay_rate`` every ``--lr_decay_epochs``
    epochs of updates (optax's staircase `exponential_decay`), as
    (optimizer, per-update scheduler)."""
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    every = args.lr_decay_epochs * steps_per_epoch
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: args.lr_decay_rate ** (k // every))
    return opt, sched


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One batch of cross entropy over every point; returns the loss (still
    on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(x, None, generator)
    loss = cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Class ids [B, N] in eval mode."""
    model.eval()
    return model(x).argmax(-1)


def evaluate(model: torch.nn.Module, args, xs: np.ndarray, ys: np.ndarray,
             dev: torch.device, predict_fn=predict) -> float:
    """mIoU over the classes present, over the whole batches of the split in
    order (`examples/sem_seg_dense/train.py:104-138`)."""
    iou = IoUAccumulator(args.n_classes)
    rng = np.random.default_rng(0)  # batch_iter draws nothing without shuffle
    for x, y in pc.batch_iter(rng, xs, ys, args.batch_size, shuffle=False):
        pred = predict_fn(model, torch.from_numpy(x).to(dev)).cpu().numpy()
        iou.update(pred.reshape(-1), y.reshape(-1))
    return iou.miou()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the best mIoU, every epoch's mean loss and mIoU, and
    the experiment directory (None without ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    (tr_x, tr_y), (te_x, te_y) = load_data(args, rng)
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    opt, sched = make_optimizer(args, model, max(len(tr_x) // args.batch_size, 1))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "sem_seg_dense")
    timer, best, losses, mious = EpochTimer(), -math.inf, [], []
    for epoch in range(args.epochs):
        ep = []
        for x, y in pc.batch_iter(rng, tr_x, tr_y, args.batch_size):
            ep.append(train_step(model, opt, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev), gen))
            sched.step()
        loss = float(torch.stack(ep).mean())
        miou = evaluate(model, args, te_x, te_y, dev)
        losses.append(loss)
        mious.append(miou)
        if miou > best:
            best = miou
            if exp is not None:
                save_ckpt(f"{exp}/ckpt_best", model=model, epoch=epoch, best_value=best)
        report(logger, f"epoch {epoch} loss {loss:.4f} mIoU {miou:.4f} ({timer.lap():.1f}s)")
        if scalars is not None:
            scalars.log(epoch, loss=loss, miou=miou)
    report(logger, f"best mIoU {best:.4f}")
    return {"best": best, "losses": losses, "miou": mious, "exp": exp}


if __name__ == "__main__":
    main()
