"""DeeperGCN on an ogbn-arxiv-shaped task: full-batch node classification
(counterpart of `examples/ogbn_arxiv/main.py:18-215`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_arxiv --synthetic \\
        [--synthetic_nodes N] [--epochs E] [--device cuda|cpu] \\
        [--reorder none|rcm|cluster] [--band off|auto]

Same defaults as the JAX app: ResGEN-28 (res+, softmax_sg, t=0.1, batch
norm, one-layer MLP), C=128, dropout 0.5, Adam lr 0.01. One train step per
epoch and an eval `predict` every 5 epochs and at the last. ``--reorder``
relabels the graph by a locality pass (`data/reorder.py`) and ``--band auto``
attaches the band adjacency, which moves GENConv's aggregation to the band
route (`examples/ogbn_arxiv/main.py:38-70, 102-118`). This slice has the
synthetic SBM task only; OGB loading and the parallel flags come later.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.reorder import cluster_order, invert_permutation, permute_graph, rcm_order
from ..data.synthetic import sbm_arxiv_like
from ..device import resolve_device
from ..graph import Graph, attach_band, build_graph
from ..models import DeeperGCN, DeeperGCNConfig
from ..utils.loss import cross_entropy
from ..utils.metrics import accuracy
from ..utils.optim import make_optimizer


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DeeperGCN on ogbn-arxiv (PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic SBM stand-in (the only data source of this slice)")
    p.add_argument("--synthetic_nodes", type=int, default=4096)
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


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_args(argv)
    if not args.synthetic:
        raise NotImplementedError("OGB dataset loading is not ported yet; pass --synthetic")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    n = args.synthetic_nodes
    g, labels = sbm_arxiv_like(rng, n=n, num_classes=args.num_classes, c=128,
                               avg_degree=12)
    perm = rng.permutation(n)
    splits = {"train": perm[: int(0.6 * n)], "valid": perm[int(0.6 * n): int(0.8 * n)],
              "test": perm[int(0.8 * n):]}
    # rebuild through the same reorder/band pipeline as real data
    g, labels, splits = reorder_and_band(args, g, labels, splits)
    g = g.to(dev)
    lab = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    lab[:n] = torch.from_numpy(labels)
    lab = lab.to(dev)
    train_mask = torch.zeros(g.num_nodes_padded, dtype=torch.bool)
    train_mask[torch.from_numpy(splits["train"])] = True
    train_mask = train_mask.to(dev)

    init_gen = torch.Generator().manual_seed(args.seed)
    cfg = DeeperGCNConfig(
        in_channels=128, hidden_channels=args.hidden_channels,
        num_tasks=args.num_classes, num_layers=args.num_layers, block=args.block,
        aggr=args.gcn_aggr, t=args.t, learn_t=args.learn_t, norm=args.norm,
        mlp_layers=args.mlp_layers, dropout=args.dropout,
        compute_dtype=args.compute_dtype)
    model = DeeperGCN(cfg, generator=init_gen).to(dev)
    opt = make_optimizer("adam", model.parameters(), args.lr, args.weight_decay)
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    best_valid, loss, t0 = -1.0, float("nan"), time.time()
    for epoch in range(args.epochs):
        loss_t = train_step(model, opt, g, lab, train_mask, drop_gen)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            pred = predict(model, g).cpu().numpy()
            accs = {k: accuracy(pred[v], labels[v]) for k, v in splits.items()}
            loss = float(loss_t)
            print(f"epoch {epoch} loss {loss:.4f} train {accs['train']:.4f} "
                  f"valid {accs['valid']:.4f} test {accs['test']:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
            best_valid = max(best_valid, accs["valid"])
    return {"loss": loss, "best_valid": best_valid}


if __name__ == "__main__":
    main()
