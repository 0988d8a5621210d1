"""DeepGCN classifier on ModelNet40 (counterpart of `examples/modelnet_cls/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.modelnet_cls --synthetic \\
        [--epochs E] [--device cuda|cpu] [--save_ckpt]
    python -m deep_gcns_torch_tpu_torch.apps.modelnet_cls --synthetic --phase test \\
        --pretrained_model <exp>/ckpt_best [the training run's flags]

The defaults are the JAX app's ResGCN-14: 13 res blocks of EdgeConv at 64
channels, k = 9, block i at dilation 1 + i, stochastic dilation (ε = 0.2),
batch norm, fusion to 1,024 dims, clouds of 1,024 points in batches of 32,
40 classes; smoothed cross entropy (0.2), SGD with momentum 0.9 and weight
decay 1e-4 on a per-update cosine from ``--lr`` 0.1 to 0.001, dropout 0.5,
random scale and shift of each training batch. Each epoch scores the
overall and the balanced accuracy of the test clouds; with ``--save_ckpt``
a new best overall accuracy writes `{exp}/ckpt_best`. ``--phase test``
scores ``--pretrained_model`` once (`main.py:172-182`); in the train phase
it resumes from that checkpoint's next epoch.

Data: ``--synthetic`` draws the JAX app's clouds (256 train, then 64 test:
class-dependent anisotropic Gaussian blobs); the ModelNet40 h5 files are
not in the repository.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data import pointcloud as pc
from ..device import resolve_device
from ..models import DeepGCNCls, DeepGCNConfig
from ..utils.ckpt import load_ckpt, save_ckpt
from ..utils.loss import smooth_cross_entropy
from ..utils.metrics import accuracy, balanced_accuracy
from ..utils.optim import sgd_cosine
from .common import EpochTimer, base_parser, open_experiment, report
from .sem_seg_dense import add_point_flags


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeepGCN ModelNet40 classification (PyTorch/CUDA)")
    p.add_argument("--phase", type=str, default="train", choices=["train", "test"],
                   help="test = score --pretrained_model once")
    add_point_flags(p, k=9, n_blocks=14, in_channels=3, n_classes=40, num_points=1024,
                    batch_size=32)
    p.add_argument("--act", type=str, default="relu")
    p.add_argument("--emb_dims", type=int, default=1024)
    p.add_argument("--use_dilation", action="store_true", default=True)
    p.add_argument("--use_stochastic", action="store_true", default=True)
    p.add_argument("--epsilon", type=float, default=0.2)
    p.set_defaults(epochs=400, lr=0.1, dropout=0.5)
    return p.parse_args(argv)


def build_model(args, generator: Optional[torch.Generator] = None) -> DeepGCNCls:
    return DeepGCNCls(DeepGCNConfig(
        in_channels=args.in_channels, n_classes=args.n_classes, n_filters=args.n_filters,
        n_blocks=args.n_blocks, conv=args.conv, act=args.act, norm=args.norm,
        block=args.block, dropout=args.dropout, k=args.k, knn_method=args.knn_method,
        compute_dtype=args.compute_dtype or None, use_dilation=args.use_dilation,
        stochastic=args.use_stochastic, epsilon=args.epsilon, emb_dims=args.emb_dims),
        generator=generator)


def load_split(args, rng: np.random.Generator, split: str):
    if args.synthetic:
        n = 256 if split == "train" else 64
        return pc.synthetic_modelnet(rng, n, args.num_points, args.n_classes)
    return pc.load_modelnet40(args.data_root, split, args.num_points)


def make_optimizer(args, model: torch.nn.Module, steps_per_epoch: int):
    """SGD with momentum 0.9 and weight decay 1e-4 on a per-update cosine
    from ``--lr`` to 0.001 over ``--epochs`` (`main.py:21-27`), as
    (optimizer, per-update scheduler)."""
    return sgd_cosine(model.parameters(), args.lr, args.epochs * steps_per_epoch, momentum=0.9,
                      weight_decay=1e-4, min_lr=0.001)


def train_step(model: DeepGCNCls, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One batch of smoothed cross entropy; returns the loss (on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = smooth_cross_entropy(model(x, generator), y, 0.2)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: DeepGCNCls, x: torch.Tensor) -> torch.Tensor:
    model.eval()
    return model(x).argmax(-1)


def evaluate(model: DeepGCNCls, args, xs: np.ndarray, ys: np.ndarray, dev: torch.device):
    """(overall, balanced) accuracy over the whole batches of the split."""
    preds, labels = [], []
    for x, y in pc.batch_iter(np.random.default_rng(0), xs, ys, args.batch_size,
                              shuffle=False):
        preds.append(predict(model, torch.from_numpy(x).to(dev)).cpu().numpy())
        labels.append(y)
    pred, lab = np.concatenate(preds), np.concatenate(labels)
    return accuracy(pred, lab), balanced_accuracy(pred, lab)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train (or, with ``--phase test``, score); returns the best overall
    accuracy, every epoch's loss, accuracy and balanced accuracy, the
    experiment directory (None without ``--save_ckpt``), or the test
    phase's {"oa", "balanced", "meta"}."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    if args.phase == "train" or args.synthetic:
        # synthetic test clouds follow the train clouds in the seed's stream
        tr_x, tr_y = load_split(args, rng, "train")
    te_x, te_y = load_split(args, rng, "test")
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    start, meta = 0, {}
    if args.pretrained_model:
        meta = load_ckpt(args.pretrained_model, model=model)
        start = int(meta.get("epoch", -1)) + 1
        print(f"loaded {args.pretrained_model} (epoch {meta.get('epoch')}, "
              f"best {meta.get('best_value', float('nan')):.4f})", flush=True)
    if args.phase == "test":
        oa, ba = evaluate(model, args, te_x, te_y, dev)
        print(f"Test Overall Acc {oa:.4f}, Its test avg acc {ba:.4f}.", flush=True)
        return {"oa": oa, "balanced": ba, "meta": meta}
    opt, sched = make_optimizer(args, model, max(len(tr_x) // args.batch_size, 1))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "modelnet_cls")
    timer, best, losses, oas, bas = EpochTimer(), 0.0, [], [], []
    for epoch in range(start, args.epochs):
        ep = []
        for x, y in pc.batch_iter(rng, tr_x, tr_y, args.batch_size, augment=True):
            ep.append(train_step(model, opt, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev), gen))
            sched.step()
        loss = float(torch.stack(ep).mean())
        oa, ba = evaluate(model, args, te_x, te_y, dev)
        losses.append(loss)
        oas.append(oa)
        bas.append(ba)
        if oa > best:
            best = oa
            if exp is not None:
                save_ckpt(f"{exp}/ckpt_best", model=model, epoch=epoch, best_value=best)
        report(logger, f"epoch {epoch} loss {loss:.4f} OA {oa:.4f} balanced {ba:.4f} "
                       f"({timer.lap():.1f}s)")
        if scalars is not None:
            scalars.log(epoch, loss=loss, oa=oa, balanced=ba)
    report(logger, f"best OA {best:.4f}")
    return {"best": best, "losses": losses, "oa": oas, "balanced": bas, "exp": exp}


if __name__ == "__main__":
    main()
