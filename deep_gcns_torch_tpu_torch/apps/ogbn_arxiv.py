"""DeeperGCN on an ogbn-arxiv-shaped task: full-batch node classification
(counterpart of `examples/ogbn_arxiv/main.py:18-215`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_arxiv --synthetic \\
        [--synthetic_nodes N] [--epochs E] [--device cuda|cpu] \\
        [--reorder none|rcm|cluster] [--band off|auto] [--remat] \\
        [--save_ckpt] [--pretrained_model PREFIX] \\
        [--spatial N [--exchange auto|halo|allgather]] [--tp T]

Same defaults as the JAX app: ResGEN-28 (res+, softmax_sg t=0.1, batch
norm, one-layer MLP), C=128, dropout 0.5, Adam lr 0.01 (``--optimizer``
and ``--weight_decay`` as in `apps/common.py`). One train step per
epoch and an eval `predict` every 5 epochs and at the last. ``--reorder``
relabels the graph by a locality pass (`data/reorder.py`) and ``--band auto``
attaches the band adjacency, which moves GENConv's aggregation to the band
route (`examples/ogbn_arxiv/main.py:38-70, 102-118`). Without
``--synthetic`` the graph is ogbn-arxiv from the local cache
`{data_root}/ogbn_arxiv.npz` (`data/ogb.py`), made undirected with
self-loops. ``--remat`` recomputes each layer in the backward.

Checkpoints, as the JAX app (`main.py:84, 161-168, 205-213`): with
``--save_ckpt`` the run saves `{exp_root}/ogbn_arxiv-{exp_name}-…/ckpt`
(`utils/ckpt.py`) at every new best validation accuracy, with that epoch;
``--pretrained_model PREFIX`` restores the model, the optimizer and the best
value and resumes from the saved epoch, the dropout stream starting afresh
from ``seed + 1``. `apps/ogbn_arxiv_test.py` scores a checkpoint.

``--spatial N`` trains the full graph exactly on N ranks after the reorder
(`apps/spatial_common.run_spatial`, the band with ``--band auto``); its
checkpoint carries the single-process model's names, so the test script
scores it with the same data and model flags. ``--tp T`` splits the
channels over T ranks as well, on a ``--spatial`` × ``--tp`` grid
(`apps/spatial_common.run_spatial_tp`; ``--tp`` alone is the 1 × T grid);
its checkpoint holds the unsharded parameters, which the test script
scores in one process.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.ogb import load_ogb_node
from ..data.reorder import cluster_order, invert_permutation, permute_graph, rcm_order
from ..data.synthetic import sbm_arxiv_like
from ..device import resolve_device
from ..graph import Graph, add_self_loops, attach_band, build_graph, to_undirected
from ..models import DeeperGCN, DeeperGCNConfig
from ..utils.ckpt import load_ckpt, save_best, save_ckpt
from ..utils.logger import create_exp_dir
from ..utils.loss import cross_entropy
from ..utils.metrics import accuracy
from ..utils.optim import make_optimizer
from .common import add_optimizer_flags, add_spatial_flags
from .spatial_common import run_spatial, run_spatial_tp


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DeeperGCN on ogbn-arxiv (PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=0.01)
    add_optimizer_flags(p)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic SBM stand-in for ogbn-arxiv")
    p.add_argument("--synthetic_nodes", type=int, default=4096)
    p.add_argument("--data_root", type=str, default="data/",
                   help="directory of the ogbn_arxiv.npz cache")
    p.add_argument("--exp_root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--save_ckpt", action="store_true",
                   help="save a checkpoint at every new best validation accuracy")
    p.add_argument("--pretrained_model", type=str, default="",
                   help="checkpoint prefix to resume from (or to score, in the test script)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer in the backward (torch.utils.checkpoint)")
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--num_layers", type=int, default=28)
    p.add_argument("--hidden_channels", type=int, default=128)
    p.add_argument("--block", type=str, default="res+")
    p.add_argument("--gcn_aggr", type=str, default="softmax_sg")
    p.add_argument("--norm", type=str, default="batch")
    p.add_argument("--mlp_layers", type=int, default=1)
    p.add_argument("--t", type=float, default=0.1)
    p.add_argument("--learn_t", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--reorder", type=str, default="none", choices=["none", "rcm", "cluster"],
                   help="host locality reordering (data/reorder.py) before building "
                        "the graph; enables the gather-free band aggregation")
    p.add_argument("--band", type=str, default="off", choices=["off", "auto"],
                   help="attach the band-dense adjacency (ops/band.py); combine with "
                        "--reorder cluster on real graphs")
    add_spatial_flags(p)
    return p.parse_args(argv)


def _reorder(args, s, r, n, x_np, labels, splits):
    """Apply the selected locality pass; node arrays and split index sets are
    relabelled consistently (the metrics do not depend on node order)."""
    if args.reorder == "none":
        return s, r, x_np, labels, splits
    if args.reorder == "rcm":
        perm = rcm_order(s, r, n)
    else:
        perm = cluster_order(s, r, n, cluster_size=4096)
    s, r, x_np, labels = permute_graph(perm, s, r, x_np, np.asarray(labels))
    inv = invert_permutation(np.asarray(perm))
    splits = {k: inv[np.asarray(v)] for k, v in splits.items()}
    return s, r, x_np, labels, splits


def _maybe_band(args, g: Graph) -> Graph:
    if args.band == "off":
        return g
    g = attach_band(g, hubs="auto" if getattr(args, "band_hubs", "auto") == "auto" else None)
    print(f"band attached: window={g.band.fwd.window} coverage={g.band.fwd.coverage:.3f} "
          f"(bwd {g.band.bwd.coverage:.3f})", flush=True)
    return g


def reorder_and_band(args, g: Graph, labels, splits):
    """``--reorder``/``--band`` on a host graph of ``g.n_node`` valid nodes:
    rebuild it through the locality pass and attach the band, relabelling
    the labels and split index sets alike (a no-op when both are off)."""
    if args.reorder == "none" and args.band == "off":
        return g, labels, splits
    n = g.n_node
    s = g.senders[:g.n_edge].numpy()
    r = g.receivers[:g.n_edge].numpy()
    x_np = g.x[:n].numpy()
    s, r, x_np, labels, splits = _reorder(args, s, r, n, x_np, labels, splits)
    return _maybe_band(args, build_graph(x_np, s, r, num_nodes=n)), labels, splits


def train_step(model: DeeperGCN, opt: torch.optim.Optimizer, g: Graph,
               labels: torch.Tensor, mask: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One full-batch step; returns the loss (still on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = cross_entropy(model(g.x, g, generator), labels, mask)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: DeeperGCN, g: Graph) -> torch.Tensor:
    model.eval()
    return model(g.x, g).argmax(-1)


def load_data(args, rng: np.random.Generator):
    """(host graph, labels [N], splits, input width) after ``--reorder`` and
    ``--band``: the synthetic SBM drawn from ``rng``, or ogbn-arxiv from the
    local cache, made undirected, with self-loops
    (`examples/ogbn_arxiv/main.py:79-139`)."""
    if args.synthetic:
        n = args.synthetic_nodes
        g, labels = sbm_arxiv_like(rng, n=n, num_classes=args.num_classes, c=128,
                                   avg_degree=12)
        perm = rng.permutation(n)
        splits = {"train": perm[: int(0.6 * n)], "valid": perm[int(0.6 * n): int(0.8 * n)],
                  "test": perm[int(0.8 * n):]}
    else:
        ds = load_ogb_node("ogbn-arxiv", args.data_root)
        n = ds.x.shape[0]
        s, r = add_self_loops(*to_undirected(ds.senders, ds.receivers), n)
        g = build_graph(ds.x.astype(np.float32), s, r, num_nodes=n)
        labels, splits = np.asarray(ds.labels).reshape(-1), ds.splits
    # rebuild through the same reorder/band pipeline as real data
    g, labels, splits = reorder_and_band(args, g, labels, splits)
    return g, np.asarray(labels), splits, g.x.shape[1]


def build_model(args, in_dim: int, generator: Optional[torch.Generator] = None) -> DeeperGCN:
    return DeeperGCN(DeeperGCNConfig(
        in_channels=in_dim, hidden_channels=args.hidden_channels,
        num_tasks=args.num_classes, num_layers=args.num_layers, block=args.block,
        aggr=args.gcn_aggr, t=args.t, learn_t=args.learn_t, norm=args.norm,
        mlp_layers=args.mlp_layers, dropout=args.dropout,
        compute_dtype=args.compute_dtype, remat=args.remat), generator=generator)


def split_accuracies(pred: np.ndarray, labels: np.ndarray, splits) -> dict:
    return {k: accuracy(pred[v], labels[v]) for k, v in splits.items()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the last printed loss, the best validation accuracy,
    every epoch's loss, the accuracies of each evaluated epoch and the
    checkpoint prefix (None without ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    g, labels, splits, in_dim = load_data(args, np.random.default_rng(args.seed))
    n = g.n_node
    if args.tp > 1:
        # `examples/ogbn_arxiv/main.py:111-113, 132-134`
        return run_spatial_tp(args, "ogbn_arxiv", g, labels, splits, in_dim)
    if args.spatial > 1:
        # the reordered graph's edges, partitioned over the ranks
        # (`examples/ogbn_arxiv/main.py:100-140`)
        return run_spatial(args, "ogbn_arxiv", g.senders[:g.n_edge].numpy(),
                           g.receivers[:g.n_edge].numpy(), g.x[:n].numpy(), labels, splits,
                           in_dim, n)
    g = g.to(dev)
    lab = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    lab[:n] = torch.from_numpy(labels)
    lab = lab.to(dev)
    train_mask = torch.zeros(g.num_nodes_padded, dtype=torch.bool)
    train_mask[torch.from_numpy(splits["train"])] = True
    train_mask = train_mask.to(dev)

    model = build_model(args, in_dim, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args.optimizer, model.parameters(), args.lr, args.weight_decay)
    start_epoch, best_valid = 0, -1.0
    if args.pretrained_model:
        meta = load_ckpt(args.pretrained_model, model=model, optimizer=opt)
        start_epoch, best_valid = int(meta.get("epoch", 0)), float(meta.get("best_value", -1.0))
        print(f"resumed from {args.pretrained_model} at epoch {start_epoch}", flush=True)
    ckpt_path = None
    if args.save_ckpt:
        ckpt_path = os.path.join(create_exp_dir(args.exp_root, f"ogbn_arxiv-{args.exp_name}"),
                                 "ckpt")
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    loss, t0, losses, evals = float("nan"), time.time(), [], {}
    for epoch in range(start_epoch, args.epochs):
        loss_t = train_step(model, opt, g, lab, train_mask, drop_gen)
        losses.append(loss_t)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            accs = split_accuracies(predict(model, g).cpu().numpy(), labels, splits)
            evals[epoch] = accs
            loss = float(loss_t)
            print(f"epoch {epoch} loss {loss:.4f} train {accs['train']:.4f} "
                  f"valid {accs['valid']:.4f} test {accs['test']:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
            if accs["valid"] > best_valid:
                best_valid = accs["valid"]
                if ckpt_path:
                    save_ckpt(ckpt_path, model=model, optimizer=opt, epoch=epoch,
                              best_value=best_valid)
                    save_best(ckpt_path, True)
    return {"loss": loss, "best_valid": best_valid, "losses": [float(v) for v in losses],
            "evals": evals, "ckpt": ckpt_path}


if __name__ == "__main__":
    main()
