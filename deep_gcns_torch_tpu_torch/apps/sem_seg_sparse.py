"""SparseDeepGCN on S3DIS: the flat [B·N, C] layout with a dilated kNN graph
per block (counterpart of `examples/sem_seg_sparse/train.py`).

    python -m deep_gcns_torch_tpu_torch.apps.sem_seg_sparse --synthetic \\
        [--epochs E] [--device cuda|cpu] [--save_ckpt]

The dense app's defaults (ResGCN-28 EdgeConv, k = 16, 64 channels, 13
classes, blocks of 8 × 4,096 points with 9 channels) on PyG's flat layout:
the head's kNN on xyz, `DynConv` blocks at dilation 1 + i, the per-cloud
max of the fusion broadcast back; Adam at ``--lr`` with no decay, dropout
0.3. The flat kNN graph carries no CSR or CSC, so, as in the JAX package,
no kernel runs. Data, scoring and checkpoints as in `apps/sem_seg_dense`;
`apps/sem_seg_sparse_test.py` scores `ckpt_best`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import pointcloud as pc
from ..device import resolve_device
from ..models import DeepGCNConfig, SparseDeepGCN
from ..utils.ckpt import save_ckpt
from ..utils.loss import cross_entropy
from . import sem_seg_dense as dense
from .common import EpochTimer, base_parser, open_experiment, report

load_split, load_data = dense.load_split, dense.load_data


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("SparseDeepGCN S3DIS semantic segmentation (PyTorch/CUDA)")
    dense.add_point_flags(p, k=16, n_blocks=28, in_channels=9, n_classes=13,
                          num_points=4096, batch_size=8)
    p.add_argument("--test_area", type=int, default=5)
    p.add_argument("--stochastic", action="store_true", default=False)
    p.add_argument("--epsilon", type=float, default=0.2)
    p.set_defaults(epochs=100, lr=1e-3, dropout=0.3)
    return p.parse_args(argv)


def build_model(args, generator: Optional[torch.Generator] = None) -> SparseDeepGCN:
    return SparseDeepGCN(DeepGCNConfig(
        in_channels=args.in_channels, n_classes=args.n_classes, n_filters=args.n_filters,
        n_blocks=args.n_blocks, conv=args.conv, norm=args.norm, block=args.block,
        dropout=args.dropout, k=args.k, knn_method=args.knn_method,
        compute_dtype=args.compute_dtype or None, stochastic=args.stochastic,
        epsilon=args.epsilon, num_points=args.num_points), generator=generator)


def train_step(model: SparseDeepGCN, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One batch x [B, N, C], y [B, N], flattened; returns the loss (still
    on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = cross_entropy(model(x.reshape(-1, x.shape[-1]), None, generator), y.reshape(-1))
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: SparseDeepGCN, x: torch.Tensor) -> torch.Tensor:
    """Class ids [B, N] of x [B, N, C] in eval mode."""
    model.eval()
    return model(x.reshape(-1, x.shape[-1])).argmax(-1).reshape(x.shape[:2])


def evaluate(model: SparseDeepGCN, args, xs: np.ndarray, ys: np.ndarray,
             dev: torch.device) -> float:
    return dense.evaluate(model, args, xs, ys, dev, predict)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the best mIoU, every epoch's mean loss and mIoU, and
    the experiment directory (None without ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    (tr_x, tr_y), (te_x, te_y) = load_data(args, rng)
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "sem_seg_sparse")
    timer, best, losses, mious = EpochTimer(), -math.inf, [], []
    for epoch in range(args.epochs):
        ep = [train_step(model, opt, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                         gen)
              for x, y in pc.batch_iter(rng, tr_x, tr_y, args.batch_size)]
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
