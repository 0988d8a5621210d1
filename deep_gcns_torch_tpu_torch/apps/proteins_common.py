"""Shared ogbn-proteins machinery of the DyResGEN and RevGCN apps
(counterpart of `examples/proteins_common.py:13-199`): species one-hot and
edge-aggregated node features, a per-epoch random (or locality) partition
into clusters padded to one fixed bucket, cluster-wise training with the
global-norm clip chained before the optimizer of ``--optimizer`` (Adam by
default; ``--weight_decay`` as in `apps/common.py`), and averaged
multi-partition evaluation with ROC-AUC (`examples/ogb_eff/ogbn_proteins/main.py:158-173`).

The data is the JAX app's synthetic generator, made from ``--seed``, or
ogbn-proteins from the local cache `{data_root}/ogbn_proteins.npz`
(`data/ogb.py`). With ``--save_ckpt`` (`examples/proteins_common.py:150-196`)
each evaluation enqueues an asynchronous rolling checkpoint
(`utils/ckpt_async.py`, the last two kept, the best pinned) in
`{exp}/ckpt/{epoch}/`, and a new best validation ROC-AUC also writes
`{exp}/ckpt_best` at once (the JAX app writes `ckpt_best` without the flag
too). `apps/ogbn_proteins_test.py` scores a checkpoint. Not ported:
``--spatial`` (the parallel layer, a later slice) raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.ogb import extract_node_features_from_edges, load_ogb_node
from ..data.partition import (generate_sub_graphs, locality_partition_graph,
                              random_partition_graph, scatter_predictions)
from ..device import resolve_device
from ..graph import Graph
from ..utils.ckpt import save_ckpt
from ..utils.ckpt_async import AsyncCheckpointer
from ..utils.logger import create_exp_dir
from ..utils.loss import bce_with_logits
from ..utils.metrics import roc_auc
from ..utils.optim import clip_grad_global_norm_, make_optimizer
from .common import add_optimizer_flags

MAX_GRAD_NORM = 1.0  # optax.clip_by_global_norm(1.0) of the JAX apps


def base_parser(description: str, *, num_layers: int, hidden: int, epochs: int,
                lr: float) -> argparse.ArgumentParser:
    """The flag surface of the JAX proteins apps (`examples/common.py`,
    `examples/ogbn_proteins/main.py:17-34`)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--lr", type=float, default=lr)
    add_optimizer_flags(p)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic proteins-shaped data instead of the ogbn-proteins cache")
    p.add_argument("--data_root", type=str, default="data/",
                   help="directory of the ogbn_proteins.npz cache")
    p.add_argument("--exp_root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--save_ckpt", action="store_true",
                   help="asynchronous rolling checkpoints at each evaluation, and the best")
    p.add_argument("--pretrained_model", type=str, default="",
                   help="checkpoint prefix to score (the test script)")
    p.add_argument("--remat", action="store_true",
                   help="DeeperGCN: recompute each layer in the backward")
    p.add_argument("--synthetic_nodes", type=int, default=4096)
    p.add_argument("--synthetic_degree", type=int, default=30)
    p.add_argument("--num_layers", type=int, default=num_layers)
    p.add_argument("--hidden_channels", type=int, default=hidden)
    p.add_argument("--block", type=str, default="res+")
    p.add_argument("--gcn_aggr", type=str, default="softmax")
    p.add_argument("--norm", type=str, default="layer")
    p.add_argument("--mlp_layers", type=int, default=1)
    p.add_argument("--t", type=float, default=1.0)
    p.add_argument("--learn_t", action="store_true")
    p.add_argument("--p", type=float, default=1.0)
    p.add_argument("--learn_p", action="store_true")
    p.add_argument("--y", type=float, default=0.0)
    p.add_argument("--learn_y", action="store_true")
    p.add_argument("--msg_norm", action="store_true")
    p.add_argument("--learn_msg_scale", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--num_tasks", type=int, default=112)
    p.add_argument("--cluster_number", type=int, default=10)
    p.add_argument("--partition", type=str, default="random", choices=["random", "locality"],
                   help="random = the reference's uniform partition; locality = the "
                        "greedy cluster order cut into chunks (keeps far more edges)")
    p.add_argument("--eval_parts", type=int, default=5)
    p.add_argument("--num_evals", type=int, default=1)
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--conv_encode_edge", action="store_true", default=True)
    p.add_argument("--use_one_hot_encoding", action="store_true", default=True)
    p.add_argument("--spatial", type=int, default=1,
                   help="edge-partitioned full-graph training over N devices (not ported)")
    return p


def load_proteins(args, rng: np.random.Generator) -> dict:
    """The JAX app's synthetic ogbn-proteins stand-in (`proteins_common.py:16-34`),
    draw for draw: uniform edges, 8-dim edge features, species one-hot, node
    features aggregated from the edges, labels that a linear map of them
    decides, and a 65/15/20 split. Without ``--synthetic``, ogbn-proteins
    from the local cache: species one-hot as x, node features aggregated
    from the edges (`examples/proteins_common.py:35-46`)."""
    if not args.synthetic:
        ds = load_ogb_node("ogbn-proteins", args.data_root)
        n = ds.labels.shape[0]
        return dict(senders=ds.senders, receivers=ds.receivers, edge_attr=ds.edge_attr,
                    species=ds.x,
                    node_feats=extract_node_features_from_edges(ds.senders, ds.receivers,
                                                                ds.edge_attr, n),
                    labels=ds.labels.astype(np.float32), splits=ds.splits,
                    num_nodes=len(ds.x))
    n = args.synthetic_nodes
    e = n * args.synthetic_degree
    senders = rng.integers(0, n, e)
    receivers = rng.integers(0, n, e)
    edge_attr = rng.random((e, 8)).astype(np.float32)
    species = np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)]
    node_feats = extract_node_features_from_edges(senders, receivers, edge_attr, n)
    w = rng.standard_normal((8, args.num_tasks)).astype(np.float32)
    labels = ((node_feats - node_feats.mean(0)) @ w > 0).astype(np.float32)
    perm = rng.permutation(n)
    splits = {"train": perm[: int(0.65 * n)], "valid": perm[int(0.65 * n): int(0.8 * n)],
              "test": perm[int(0.8 * n):]}
    return dict(senders=senders, receivers=receivers, edge_attr=edge_attr, species=species,
                node_feats=node_feats, labels=labels, splits=splits, num_nodes=n)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, g: Graph,
               species: torch.Tensor, node_feats: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One cluster step: masked multi-task BCE, the global-norm clip, the update.
    Returns the loss (still on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(species, g, node_feats=node_feats, generator=generator)
    loss = bce_with_logits(logits, labels, mask)
    loss.backward()
    clip_grad_global_norm_(model.parameters(), MAX_GRAD_NORM)
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: torch.nn.Module, g: Graph, species: torch.Tensor,
            node_feats: torch.Tensor) -> torch.Tensor:
    """Logits of one cluster in eval mode (ROC-AUC only ranks them)."""
    model.eval()
    return model(species, g, node_feats=node_feats)


def run_proteins(args, build_model: Callable, name: str) -> dict:
    """Partition-train and multi-partition evaluation loop
    (`examples/proteins_common.py:52-199`). Returns the last evaluation, the
    best validation ROC-AUC, the last epoch's mean loss and the host seconds
    of each epoch's partition."""
    if args.spatial > 1:
        raise NotImplementedError("--spatial (the parallel layer) is not ported yet")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    data = load_proteins(args, rng)
    n, labels = data["num_nodes"], data["labels"]
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args.optimizer, model.parameters(), args.lr, args.weight_decay)
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    # one padded bucket for every cluster, sized for the coarsest partition used
    min_parts = min(args.cluster_number, args.eval_parts)
    node_pad = ((n // min_parts + 1023) // 256 + 1) * 256
    edge_pad = None  # set by the first partition; grows (rarely) when one needs more
    train_mask = np.zeros((n, 1), np.float32)
    train_mask[data["splits"]["train"]] = 1.0

    def make_clusters(parts, ncl):
        nonlocal edge_pad
        ps, pr = parts[data["senders"]], parts[data["receivers"]]
        counts = np.bincount(ps[ps == pr], minlength=ncl)
        needed = int(counts.max()) if counts.size else 1
        if edge_pad is None or needed > edge_pad:
            edge_pad = ((int(needed * 1.2) + 511) // 512) * 512
        return generate_sub_graphs(
            data["senders"], data["receivers"], parts, ncl, edge_attr=data["edge_attr"],
            node_feats=[data["species"], data["node_feats"], labels, train_mask],
            node_pad=node_pad, edge_pad=edge_pad)

    def evaluate() -> dict:
        pred = multi_view_predict(model, data, dev, args.eval_parts, args.num_evals,
                                  make_clusters)
        return {k: roc_auc(pred[idx], labels[idx]) for k, idx in data["splits"].items()}

    def partition(rng_):
        if args.partition == "locality":
            return locality_partition_graph(rng_, data["senders"], data["receivers"], n,
                                            args.cluster_number)
        return random_partition_graph(rng_, n, args.cluster_number)

    exp = ckpt = None
    if args.save_ckpt:
        exp = create_exp_dir(args.exp_root, f"{name}-{args.exp_name}")
        ckpt = AsyncCheckpointer(os.path.join(exp, "ckpt"), max_to_keep=2)
    best_valid, results, partition_s, ep_loss = -1.0, {}, [], float("nan")
    t0 = time.time()
    for epoch in range(args.epochs):
        tp = time.perf_counter()
        graphs, _, feats = make_clusters(partition(rng), args.cluster_number)
        partition_s.append(time.perf_counter() - tp)
        losses = []
        for ci in rng.permutation(args.cluster_number):
            g = graphs[ci].to(dev)
            sp, nf, lab, tm = (torch.from_numpy(a).to(dev) for a in feats[ci])
            losses.append(train_step(model, opt, g, sp, nf, lab, (tm[:, 0] > 0) & g.node_mask,
                                     drop_gen))
        ep_loss = float(torch.stack(losses).mean())
        if epoch % args.eval_every == 0 or epoch == args.epochs - 1:
            results = evaluate()
            if exp is not None and results["valid"] > best_valid:
                save_ckpt(os.path.join(exp, "ckpt_best"), model=model, epoch=epoch,
                          best_value=results["valid"])
            best_valid = max(best_valid, results["valid"])
            print(f"[{name}] epoch {epoch} loss {ep_loss:.4f} train {results['train']:.4f} "
                  f"valid {results['valid']:.4f} test {results['test']:.4f} "
                  f"(partition {partition_s[-1]:.2f}s, {time.time() - t0:.1f}s)", flush=True)
            if ckpt is not None:
                ckpt.save(epoch, model=model, optimizer=opt, metrics={"valid": results["valid"]},
                          meta={"epoch": epoch, "best_value": best_valid})
    if ckpt is not None:
        ckpt.close()
    return {"loss": ep_loss, "best_valid": best_valid, "results": results,
            "partition_s": partition_s, "exp": exp}


def multi_view_predict(model: torch.nn.Module, data: dict, dev: torch.device, num_parts: int,
                       num_evals: int, clusters: Callable) -> np.ndarray:
    """Predictions [N, T] averaged over ``num_evals`` random partitions into
    ``num_parts`` clusters (`examples/ogb_eff/ogbn_proteins/main.py:158-173`);
    view e partitions with the seed 1000 + e. ``clusters(parts, k)`` cuts the
    graph into (graphs, node lists, [species, node features, …])."""
    n = data["num_nodes"]
    pred_sum = np.zeros(data["labels"].shape, np.float32)
    for e in range(num_evals):
        parts = random_partition_graph(np.random.default_rng(1000 + e), n, num_parts)
        graphs, node_lists, feats = clusters(parts, num_parts)
        preds = [predict(model, g.to(dev), torch.from_numpy(f[0]).to(dev),
                         torch.from_numpy(f[1]).to(dev)).float().cpu().numpy()
                 for g, f in zip(graphs, feats)]
        pred_sum += scatter_predictions(preds, node_lists, n)
    return pred_sum / num_evals
