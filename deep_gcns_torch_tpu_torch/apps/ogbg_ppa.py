"""DeeperGCN on ogbg-ppa — graph classification into 37 classes (counterpart
of `examples/ogbg_ppa/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbg_ppa --synthetic \\
        [--epochs E] [--device cuda|cpu] [--save_ckpt]

The defaults are the JAX app's ResGEN-28 (res+, softmax_sg at t=0.01, batch
norm, C=128, dropout 0.5, Adam 0.01, batches of 16 graphs): the node
features are the sum of each node's incoming 7-dim edge features, one
Linear(7, C) encodes them and one model-level Linear(7, C) the edge
features ("one_time"), mean pooling, cross entropy. As in the JAX app,
``--compute_dtype`` and ``--remat`` are not passed to the model.

The data is the JAX app's synthetic graph list, made from ``--seed`` draw
for draw: 160 graphs of 20-49 nodes with 4n edges, labelled by a random
linear map of their mean edge features, 80/20 split. The evaluation scores
every test graph (the last partial batch padded and trimmed, as the test
script does), so `apps/ogbg_ppa_test.py` reproduces the accuracy of the
epoch it loads. With ``--save_ckpt`` a new best accuracy writes
`{exp}/ckpt_best`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph import Graph
from ..models import DeeperGCN, DeeperGCNConfig
from ..utils.ckpt import save_ckpt
from ..utils.loss import cross_entropy
from ..utils.metrics import accuracy
from .common import (EpochTimer, add_deeper_gcn_flags, base_parser, make_optimizer,
                     open_experiment, report)
from .ogbg_mol import make_batcher, predict_all


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeeperGCN on ogbg-ppa (PyTorch/CUDA)")
    add_deeper_gcn_flags(p, num_layers=28, hidden=128, norm="batch", t=0.01,
                         aggr="softmax_sg")
    p.add_argument("--num_classes", type=int, default=37)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--graph_pooling", type=str, default="mean")
    p.set_defaults(epochs=200, lr=0.01, dropout=0.5)
    return p.parse_args(argv)


def load_ppa(args, rng: np.random.Generator) -> Tuple[List[dict], List[dict]]:
    """(train, test) graph lists with 7-dim float edge features and node
    features scattered from them (`examples/ogbg_ppa/main.py:27-47`)."""
    if not args.synthetic:
        raise FileNotFoundError("ogbg-ppa needs a local cache; pass --synthetic")
    gs = []
    W = rng.standard_normal((7, args.num_classes)).astype(np.float32)
    for _ in range(160):
        n = int(rng.integers(20, 50))
        e = n * 4
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
        ea = rng.random((e, 7)).astype(np.float32)
        y = int(np.argmax(ea.mean(0) @ W))
        x = np.zeros((n, 7), np.float32)
        np.add.at(x, r, ea)
        gs.append(dict(x=x, senders=s, receivers=r, edge_attr=ea, y=y))
    n_tr = int(0.8 * len(gs))
    return gs[:n_tr], gs[n_tr:]


def build_model(args, generator: Optional[torch.Generator] = None) -> DeeperGCN:
    return DeeperGCN(DeeperGCNConfig(
        in_channels=7, hidden_channels=args.hidden_channels, num_tasks=args.num_classes,
        num_layers=args.num_layers, block=args.block, aggr=args.gcn_aggr, t=args.t,
        learn_t=args.learn_t, norm=args.norm, mlp_layers=args.mlp_layers,
        dropout=args.dropout, edge_mode="one_time", edge_feat_dim=7,
        graph_pooling=args.graph_pooling, final_relu=False), generator=generator)


def label(g: dict) -> np.ndarray:
    return np.asarray(g["y"], np.int64)


def train_step(model: DeeperGCN, opt: torch.optim.Optimizer, g: Graph, y: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One batch of cross entropy; returns the loss (still on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = cross_entropy(model(g.x, g, generator), y)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: DeeperGCN, g: Graph) -> torch.Tensor:
    """Predicted classes of a batch's graphs."""
    model.eval()
    return model(g.x, g).argmax(-1)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the best accuracy, every epoch's mean loss and
    accuracy, and the experiment directory (None without ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    train_gs, test_gs = load_ppa(args, rng)
    B = args.batch_size
    make_batch = make_batcher(B, train_gs + test_gs, label)
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args, model.parameters())
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "ogbg_ppa")
    timer, best, losses, accs = EpochTimer(), -math.inf, [], []
    for epoch in range(args.epochs):
        order = rng.permutation(len(train_gs))
        ep = []
        for i in range(0, len(order) - B + 1, B):
            gr, y = make_batch([train_gs[j] for j in order[i: i + B]])
            ep.append(train_step(model, opt, gr.to(dev), y.to(dev), drop_gen))
        loss = float(torch.stack(ep).mean())
        acc = accuracy(*predict_all(model, test_gs, B, make_batch, dev, predict))
        losses.append(loss)
        accs.append(acc)
        if acc > best:
            best = acc
            if exp is not None:
                save_ckpt(f"{exp}/ckpt_best", model=model, epoch=epoch, best_value=best)
        report(logger, f"epoch {epoch} loss {loss:.4f} acc {acc:.4f} ({timer.lap():.1f}s)")
        if scalars is not None:
            scalars.log(epoch, loss=loss, acc=acc)
    report(logger, f"best acc {best:.4f}")
    return {"best": best, "losses": losses, "accs": accs, "exp": exp}


if __name__ == "__main__":
    main()
