"""DeeperGCN on ogbn-products — random-partition cluster training and
partitioned evaluation (counterpart of `examples/ogbn_products/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_products --synthetic \\
        [--synthetic_nodes N] [--cluster_number K] [--epochs E] \\
        [--device cuda|cpu] [--save_ckpt]

The defaults are the JAX app's ResGEN-14 (res+, softmax_sg at t=0.1, batch
norm, C=128, 47 classes, dropout 0.5, Adam 0.001): each epoch partitions the
nodes uniformly at random into ``--cluster_number`` clusters (10), keeps
each cluster's inner edges and takes one step a cluster, in a random order,
with cross entropy over the cluster's training nodes. Every
``--eval_every`` epochs and at the last, the evaluation partitions the
graph once more into ``--eval_cluster_number`` clusters (seed 777, the same
every time), predicts each and puts the predictions back in node order
(`eval_partitioned`; the reference evaluated the full graph on the CPU).
Every cluster is padded to one node bucket, sized for the evaluation's
coarser partition, and one edge bucket that grows when a partition needs
more. As in the JAX app, ``--compute_dtype`` and ``--remat`` are not passed
to the model. ``--spatial N`` trains the full graph exactly on N ranks
instead (`apps/spatial_common.run_spatial`, which, as the JAX app's, does
pass them); ``--tp`` > 1 is refused (the JAX app parses it and never reads
it).

The data is the JAX app's, made from ``--seed`` draw for draw: the synthetic
SBM (100 features, average degree 10, made undirected with self-loops),
split 10/10/80. Without ``--synthetic`` ogbn-products comes from the local
cache `{data_root}/ogbn_products.npz` (`data/ogb.py`). With ``--save_ckpt`` a
new best validation accuracy writes `{exp}/ckpt_best`;
`apps/ogbn_products_test.py` scores it.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.ogb import load_ogb_node
from ..data.partition import generate_sub_graphs, random_partition_graph, scatter_predictions
from ..data.synthetic import sbm_arxiv_like
from ..device import resolve_device
from ..graph import Graph
from ..models import DeeperGCN, DeeperGCNConfig
from ..utils.ckpt import save_ckpt
from ..utils.loss import cross_entropy
from ..utils.metrics import accuracy
from .common import (EpochTimer, add_deeper_gcn_flags, add_spatial_flags, base_parser,
                     make_optimizer, open_experiment, report)
from .spatial_common import refuse_tp, run_spatial


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeeperGCN on ogbn-products (PyTorch/CUDA)")
    add_deeper_gcn_flags(p, num_layers=14, hidden=128, norm="batch", t=0.1,
                         aggr="softmax_sg")
    p.add_argument("--num_classes", type=int, default=47)
    p.add_argument("--cluster_number", type=int, default=10)
    p.add_argument("--eval_cluster_number", type=int, default=5)
    p.add_argument("--eval_every", type=int, default=5)
    add_spatial_flags(p)
    p.set_defaults(epochs=500, lr=0.001, dropout=0.5)
    return p.parse_args(argv)


def load_data(args, rng: np.random.Generator):
    """(x, senders, receivers, labels, splits, input width, N)
    (`examples/ogbn_products/main.py:32-55`)."""
    if args.synthetic:
        n = args.synthetic_nodes
        g_full, labels = sbm_arxiv_like(rng, n=n, num_classes=args.num_classes, c=100,
                                        avg_degree=10)
        em = g_full.edge_mask.numpy()
        senders = g_full.senders.numpy()[em]
        receivers = g_full.receivers.numpy()[em]
        x = g_full.x.numpy()[:n]
        perm = rng.permutation(n)
        splits = {"train": perm[: int(0.1 * n)], "valid": perm[int(0.1 * n): int(0.2 * n)],
                  "test": perm[int(0.2 * n):]}
        return x, senders, receivers, np.asarray(labels), splits, 100, n
    ds = load_ogb_node("ogbn-products", args.data_root)
    return (ds.x, ds.senders, ds.receivers, np.asarray(ds.labels).reshape(-1), ds.splits,
            ds.x.shape[1], len(ds.x))


def build_model(args, in_dim: int, generator: Optional[torch.Generator] = None) -> DeeperGCN:
    return DeeperGCN(DeeperGCNConfig(
        in_channels=in_dim, hidden_channels=args.hidden_channels, num_tasks=args.num_classes,
        num_layers=args.num_layers, block=args.block, aggr=args.gcn_aggr, t=args.t,
        learn_t=args.learn_t, norm=args.norm, mlp_layers=args.mlp_layers,
        dropout=args.dropout), generator=generator)


def node_bucket(args, n: int) -> int:
    """The node pad of every cluster, sized for the evaluation's partition
    (`examples/ogbn_products/main.py:126`)."""
    return ((n // args.eval_cluster_number + 1023) // 256 + 1) * 256


def train_step(model: DeeperGCN, opt: torch.optim.Optimizer, g: Graph, x: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One cluster step; returns the loss (still on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = cross_entropy(model(x, g, generator), labels, mask)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: DeeperGCN, g: Graph, x: torch.Tensor) -> torch.Tensor:
    model.eval()
    return model(x, g)


def eval_partitioned(args, model: DeeperGCN, x: np.ndarray, senders: np.ndarray,
                     receivers: np.ndarray, n: int, dev: torch.device, seed: int = 777,
                     predict_fn: Callable = predict) -> np.ndarray:
    """Logits [N, classes] in node order from one fixed partition into
    ``--eval_cluster_number`` clusters, each predicted on its inner edges
    (`examples/ogbn_products/main.py:68-90`)."""
    ncl = args.eval_cluster_number
    parts = random_partition_graph(np.random.default_rng(seed), n, ncl)
    graphs, node_lists, feats = generate_sub_graphs(senders, receivers, parts, ncl,
                                                    node_feats=[x], node_pad=node_bucket(args, n))
    preds = [predict_fn(model, g.to(dev), torch.from_numpy(f[0]).to(dev)).float().cpu().numpy()
             for g, f in zip(graphs, feats)]
    return scatter_predictions(preds, node_lists, n)


def split_accuracies(logits: np.ndarray, labels: np.ndarray, splits) -> dict:
    pred = logits.argmax(-1)
    return {k: accuracy(pred[idx], labels[idx]) for k, idx in splits.items()}


def cluster_builder(args, data) -> Callable:
    """``clusters(parts, k)``: the padded cluster graphs of a partition with
    each cluster's [x, label, train mask] rows (`generate_sub_graphs`), one
    node bucket for all, the edge bucket set by the first partition and
    grown when one needs more (`examples/ogbn_products/main.py:121-139`)."""
    x, senders, receivers, labels, splits, _, n = data
    train_mask = np.zeros((n, 1), np.float32)
    train_mask[splits["train"]] = 1.0
    lab = labels.astype(np.int64)[:, None]
    node_pad = node_bucket(args, n)
    edge_pad = None

    def clusters(parts, ncl):
        nonlocal edge_pad
        same = parts[senders] == parts[receivers]
        needed = int(np.bincount(parts[senders][same], minlength=ncl).max())
        if edge_pad is None or needed > edge_pad:
            edge_pad = ((int(needed * 1.2) + 511) // 512) * 512
        return generate_sub_graphs(senders, receivers, parts, ncl,
                                   node_feats=[x, lab, train_mask], node_pad=node_pad,
                                   edge_pad=edge_pad)

    return clusters


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train on ``--seed``'s data; returns what `train` returns."""
    args = get_args(argv)
    rng = np.random.default_rng(args.seed)
    return train(args, load_data(args, rng), rng)


def train(args, data, rng: np.random.Generator) -> dict:
    """The training loop on ``data`` (`load_data`'s tuple), drawing the
    partitions and the cluster order from ``rng``. Returns the best
    validation accuracy, every epoch's mean loss, the evaluated epochs'
    accuracies, the host seconds of each epoch's partition and the
    experiment directory (None without ``--save_ckpt``)."""
    refuse_tp(args, "ogbn_products")
    dev = resolve_device(args.device)
    x, senders, receivers, labels, splits, in_dim, n = data
    if args.spatial > 1:
        # exact full-graph training replaces the lossy cluster loop
        # (`examples/ogbn_products/main.py:112-116`)
        return run_spatial(args, "ogbn_products", senders, receivers, x, labels, splits,
                           in_dim, n)
    model = build_model(args, in_dim, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args, model.parameters())
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "ogbn_products")
    clusters = cluster_builder(args, data)
    timer, best_valid, losses, evals, partition_s = EpochTimer(), -math.inf, [], {}, []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        graphs, _, feats = clusters(random_partition_graph(rng, n, args.cluster_number),
                                    args.cluster_number)
        partition_s.append(time.perf_counter() - t0)
        ep = []
        for ci in rng.permutation(args.cluster_number):
            g = graphs[ci].to(dev)
            xx, yy, tm = (torch.from_numpy(a).to(dev) for a in feats[ci])
            ep.append(train_step(model, opt, g, xx, yy[:, 0], (tm[:, 0] > 0) & g.node_mask,
                                 drop_gen))
        losses.append(float(torch.stack(ep).mean()))
        if epoch % args.eval_every == 0 or epoch == args.epochs - 1:
            accs = split_accuracies(eval_partitioned(args, model, x, senders, receivers, n,
                                                     dev), labels, splits)
            evals[epoch] = accs
            if accs["valid"] > best_valid:
                best_valid = accs["valid"]
                if exp is not None:
                    save_ckpt(f"{exp}/ckpt_best", model=model, epoch=epoch,
                              best_value=best_valid)
            report(logger, f"epoch {epoch} loss {losses[-1]:.4f} train {accs['train']:.4f} "
                           f"valid {accs['valid']:.4f} test {accs['test']:.4f} "
                           f"(partition {partition_s[-1]:.2f}s, {timer.lap():.1f}s)")
            if scalars is not None:
                scalars.log(epoch, loss=losses[-1], **{f"acc_{k}": v for k, v in accs.items()})
    report(logger, f"best valid acc {best_valid:.4f}")
    return {"best_valid": best_valid, "losses": losses, "evals": evals,
            "partition_s": partition_s, "exp": exp}


if __name__ == "__main__":
    main()
