"""Full-graph spatial training of the node-classification apps over
``--spatial`` ranks (counterpart of `examples/spatial_common.py:15-110` and
`examples/proteins_common.py:202-300`): one exact full-batch step an epoch,
the graph's edges partitioned over D ranks (`parallel/spatial.py`), where
the reference trains on lossy random subgraphs.

`run_spatial` (ogbn-arxiv, ogbn-products) trains `SpatialDeeperGCN` with
cross entropy on the training split; `run_proteins_spatial` (ogbn-proteins)
trains the DyResGEN or RevGCN twin with masked multi-task BCE and the
global-norm clip at 1.0 before the optimizer; `run_spatial_tp` (ogbn-arxiv's
``--tp``, `examples/spatial_common.py:113-204`) trains
`SpatialTPDeeperGCN` on a ``--spatial`` × ``--tp`` grid of ranks (``--tp``
alone is the 1 × T grid, as in JAX). The caller's process shards
the graph and spawns the ranks (`parallel.launch`, ranks on ``--device``:
`cuda:(r % device_count)`, NCCL when each rank has a card, else gloo);
every rank builds the model from ``--seed`` (so all start alike), draws
its dropout from its own generator and joins every collective; rank 0
prints, scores the gathered full-graph logits every ``--eval_every``
epochs and at the last, and with ``--save_ckpt`` writes the checkpoint
(`utils/ckpt.py`, the single-process model's `state_dict` names, so
`apps/ogbn_arxiv_test.py` and the other test scripts score it).
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ..models import DeeperGCN, DeeperGCNConfig, RevGCN
from ..parallel import comm
from ..parallel.launch import launch
from ..parallel.mesh import make_grid
from ..parallel.spatial import (SpatialDeeperGCN, masked_bce_sum, masked_nll_sum,
                                rank_generator, shard_graph, shard_nodes, spatial_forward,
                                spatial_train_step)
from ..parallel.spatial_rev import SpatialRevGCN
from ..parallel.spatial_tp import SpatialTPDeeperGCN, spatial_tp_train_step
from ..utils.ckpt import load_ckpt, save_best, save_ckpt
from ..utils.logger import create_exp_dir
from ..utils.metrics import accuracy, roc_auc
from ..utils.optim import make_optimizer

# a rank waits this long on a collective (and the launch on its ranks)
# before the run fails
DEADLINE_S = 3600.0


def refuse_tp(args, app: str):
    """``--tp`` > 1 in an app that does not train with tensor parallelism:
    JAX's products and proteins apps parse the flag and never read it
    (`examples/common.py:104`); here a flag that would be ignored in silence
    is refused."""
    if getattr(args, "tp", 1) > 1:
        raise NotImplementedError(f"--tp: {app} does not train with tensor parallelism "
                                  "(ogbn_arxiv does)")


def deeper_gcn_config(args, in_dim: int) -> DeeperGCNConfig:
    """The spatial DeeperGCN of the app's flags (`examples/spatial_common.py:15-27`)."""
    return DeeperGCNConfig(
        in_channels=in_dim, hidden_channels=args.hidden_channels, num_tasks=args.num_classes,
        num_layers=args.num_layers, block=args.block, aggr=args.gcn_aggr, t=args.t,
        learn_t=args.learn_t, p=getattr(args, "p", 1.0), learn_p=getattr(args, "learn_p", False),
        y=getattr(args, "y", 0.0), learn_y=getattr(args, "learn_y", False),
        msg_norm=getattr(args, "msg_norm", False),
        learn_msg_scale=getattr(args, "learn_msg_scale", False), norm=args.norm,
        mlp_layers=args.mlp_layers, dropout=args.dropout, compute_dtype=args.compute_dtype,
        remat=getattr(args, "remat", False))


def _rows(mask_n: np.ndarray, shards) -> np.ndarray:
    """A node mask [N] as a [D, S] mask of valid rows."""
    return shard_nodes(mask_n[:, None], shards)[..., 0] & shards.node_mask


def _report(msg: str):
    print(msg, flush=True)


def _train_ranks(rank: int, world: int, job: dict) -> Optional[dict]:
    """One rank of a spatial run (the launched program): train, or with
    ``job["load"]`` score that checkpoint once."""
    args = job["args"]
    dev = comm.rank_device(rank, args.device)
    sh = job["shards"].rank(rank, dev)
    model = job["build"](args).to(dev)
    opt = make_optimizer(args.optimizer, model.parameters(), args.lr,
                         getattr(args, "weight_decay", 0.0))
    gen = rank_generator(args.seed + 1, rank, dev)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a[rank])).to(dev)

    x, nf, lab, mask = t(job["x"]), t(job.get("nf")), t(job["labels"]), t(job["mask"])
    losses, evals, best, t0 = [], {}, -float("inf"), time.time()

    def evaluate(epoch):
        logits = spatial_forward(model, sh, x, nf)  # every rank joins the gather
        if rank != 0:
            return None
        res = evals[epoch] = job["score"](logits.float().cpu().numpy()[:job["n"]])
        loss = f"loss {losses[-1]:.4f} " if losses else ""
        _report(f"[{job['name']} spatial D={world}] epoch {epoch} {loss}"
                f"train {res['train']:.4f} valid {res['valid']:.4f} test {res['test']:.4f} "
                f"({time.time() - t0:.2f}s)")
        return res

    meta = None
    if job.get("load"):
        meta = load_ckpt(job["load"], model=model)
        evaluate(meta.get("epoch", 0))
    else:
        for epoch in range(args.epochs):
            loss = spatial_train_step(model, opt, sh, x, lab, mask, job["loss"],
                                      node_feats=nf, generator=gen,
                                      max_grad_norm=job.get("clip"))
            losses.append(float(loss))
            if epoch % getattr(args, "eval_every", 5) == 0 or epoch == args.epochs - 1:
                res = evaluate(epoch)
                if res is not None and res["valid"] > best:
                    best = res["valid"]
                    if job["ckpt"]:
                        save_ckpt(job["ckpt"], model=model, optimizer=opt, epoch=epoch,
                                  best_value=best)
                        save_best(job["ckpt"], True)
    if rank != 0:
        return None
    return {"loss": losses[-1] if losses else float("nan"), "best_valid": best,
            "losses": losses, "evals": evals, "ckpt": job["ckpt"], "meta": meta,
            "staged_bytes": comm.STATS["staged_bytes"]}


def _launch(args, job: dict) -> dict:
    shards = job["shards"]
    _report(f"[{job['name']}] spatial: D={shards.n_dev} shard={shards.shard_size} "
            f"halo_rows/rank/layer={shards.halo_rows_per_device} exchange={args.exchange}")
    return launch(_train_ranks, shards.n_dev, (job,), device=args.device,
                  deadline=DEADLINE_S, threads=1 if args.device == "cpu" else 0)[0]


def _accuracy(labels, splits, logits) -> dict:
    """Rank 0's scorer: accuracy of the argmax on each split."""
    pred = logits.argmax(-1)
    return {k: accuracy(pred[v], labels[v]) for k, v in splits.items()}


def _roc_auc(labels, splits, logits) -> dict:
    return {k: roc_auc(logits[v], labels[v]) for k, v in splits.items()}


def _build_deeper(cfg: DeeperGCNConfig, args):
    """Every rank's SpatialDeeperGCN from ``--seed``."""
    return SpatialDeeperGCN(cfg, exchange=args.exchange,
                            generator=torch.Generator().manual_seed(args.seed))


def _build_proteins(build_model: Callable, args):
    """Every rank's spatial twin of the app's model (``build_model``'s config
    from ``--seed``, so the weights are the single-process model's)."""
    single = build_model(args, None)
    cls = SpatialRevGCN if isinstance(single, RevGCN) else SpatialDeeperGCN
    return cls(single.cfg, exchange=args.exchange,
               generator=torch.Generator().manual_seed(args.seed))


def run_spatial(args, name: str, senders: np.ndarray, receivers: np.ndarray, x: np.ndarray,
                labels: np.ndarray, splits: dict, in_dim: int, n: int,
                load: Optional[str] = None) -> dict:
    """Train DeeperGCN on the full graph over ``args.spatial`` ranks
    (`examples/spatial_common.py:30-110`), or with ``load`` score that
    checkpoint once on the same partition. Returns rank 0's last loss, best
    validation accuracy, losses, evaluations, checkpoint prefix and (with
    ``load``) the checkpoint's metadata."""
    shards = shard_graph(senders, receivers, n, args.spatial,
                         band="auto" if getattr(args, "band", "off") != "off" else "off")
    labels = np.asarray(labels).astype(np.int64)
    train = np.zeros(n, bool)
    train[np.asarray(splits["train"])] = True
    ckpt = None
    if getattr(args, "save_ckpt", False) and load is None:
        ckpt = os.path.join(create_exp_dir(args.exp_root, f"{name}-{args.exp_name}"), "ckpt")
    job = dict(name=name, args=args, shards=shards, n=n, ckpt=ckpt, load=load,
               loss=masked_nll_sum,
               build=partial(_build_deeper, deeper_gcn_config(args, in_dim)),
               x=shard_nodes(np.asarray(x, np.float32), shards),
               labels=shard_nodes(labels[:, None], shards)[..., 0],
               mask=_rows(train, shards), score=partial(_accuracy, labels, splits))
    return _launch(args, job)


def run_proteins_spatial(args, build_model: Callable, name: str, data: dict) -> dict:
    """Full-graph spatial training of the proteins apps (`examples/
    proteins_common.py:202-300`), DyResGEN or RevGCN: the edges with their
    features partitioned over ``args.spatial`` ranks, one step an epoch,
    full-graph ROC-AUC. Returns rank 0's last loss, best validation ROC-AUC,
    losses and evaluations, and the experiment directory (with
    ``--save_ckpt``: `{exp}/ckpt_best`)."""
    n, labels = data["num_nodes"], data["labels"]
    shards = shard_graph(data["senders"], data["receivers"], n, args.spatial,
                         edge_attr=data["edge_attr"])
    train = np.zeros(n, bool)
    train[np.asarray(data["splits"]["train"])] = True
    exp = create_exp_dir(args.exp_root, f"{name}-{args.exp_name}") if args.save_ckpt else None
    job = dict(name=name, args=args, shards=shards, n=n, loss=masked_bce_sum, clip=1.0,
               ckpt=None if exp is None else os.path.join(exp, "ckpt_best"),
               build=partial(_build_proteins, build_model),
               x=shard_nodes(data["species"], shards), nf=shard_nodes(data["node_feats"], shards),
               labels=shard_nodes(labels, shards), mask=_rows(train, shards),
               score=partial(_roc_auc, labels, data["splits"]))
    out = _launch(args, job)
    out["exp"] = exp
    out["results"] = out["evals"][max(out["evals"])] if out["evals"] else {}
    return out


def _train_tp_ranks(rank: int, world: int, job: dict) -> Optional[dict]:
    """One rank of a gp × tp run: train `SpatialTPDeeperGCN` on this rank's
    node shard and channel slice. Every evaluation gathers the unsharded
    parameters (a collective) and rank 0 scores the single-process
    `DeeperGCN` of them on the whole graph: the model the checkpoint holds,
    so `apps/ogbn_arxiv_test` reproduces the printed accuracies exactly
    (the TP logits differ from it by the rounding of the summed partial
    products)."""
    args = job["args"]
    dev = comm.rank_device(rank, args.device)
    grid = make_grid(args.spatial, args.tp)
    sh = job["shards"].rank(grid.gp_index, dev)
    cfg = job["cfg"]
    model = SpatialTPDeeperGCN(cfg, grid, exchange=args.exchange,
                               generator=torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args.optimizer, model.parameters(), args.lr,
                         getattr(args, "weight_decay", 0.0))
    gen = rank_generator(args.seed + 1, rank, dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[grid.gp_index])).to(dev)

    x, lab, mask = t(job["x"]), t(job["labels"]), t(job["mask"])
    losses, evals, best, t0 = [], {}, -float("inf"), time.time()
    single = g = None
    if rank == 0:
        single = DeeperGCN(cfg).to(dev).eval()
        g = job["graph"].to(dev)

    def evaluate(epoch):
        sd = model.single_state_dict()  # every rank joins the gathers
        if rank != 0:
            return None
        single.load_state_dict(sd)
        with torch.no_grad():
            logits = single(g.x, g)
        res = evals[epoch] = job["score"](logits.float().cpu().numpy()[:job["n"]])
        _report(f"[{job['name']} gp x tp {grid.gp_size}x{grid.tp_size}] epoch {epoch} "
                f"loss {losses[-1]:.4f} train {res['train']:.4f} valid {res['valid']:.4f} "
                f"test {res['test']:.4f} ({time.time() - t0:.2f}s)")
        return res

    for epoch in range(args.epochs):
        loss = spatial_tp_train_step(model, opt, sh, x, lab, mask, masked_nll_sum,
                                     generator=gen)
        losses.append(float(loss))
        if epoch % getattr(args, "eval_every", 5) == 0 or epoch == args.epochs - 1:
            res = evaluate(epoch)
            if res is not None and res["valid"] > best:
                best = res["valid"]
                if job["ckpt"]:
                    save_ckpt(job["ckpt"], model=single, epoch=epoch, best_value=best)
                    save_best(job["ckpt"], True)
    if rank != 0:
        return None
    return {"loss": losses[-1] if losses else float("nan"), "best_valid": best,
            "losses": losses, "evals": evals, "ckpt": job["ckpt"],
            "staged_bytes": comm.STATS["staged_bytes"], "collective_calls": comm.STATS["calls"]}


def run_spatial_tp(args, name: str, g, labels: np.ndarray, splits: dict, in_dim: int
                   ) -> dict:
    """Train DeeperGCN on the full host graph ``g`` over a ``--spatial`` ×
    ``--tp`` grid of ranks (JAX `run_spatial_tp`, `examples/spatial_common.py:
    113-204`): nodes edge-partitioned over the gp rows, channels over the tp
    columns. With ``--save_ckpt`` the checkpoint holds the unsharded
    parameters under the single-process names (JAX `:196-200`). Returns rank
    0's last loss, best validation accuracy, losses, evaluations and
    checkpoint prefix."""
    n = g.n_node
    D, T = args.spatial, args.tp
    shards = shard_graph(g.senders[:g.n_edge].numpy(), g.receivers[:g.n_edge].numpy(), n, D)
    labels = np.asarray(labels).astype(np.int64)
    train = np.zeros(n, bool)
    train[np.asarray(splits["train"])] = True
    ckpt = None
    if getattr(args, "save_ckpt", False):
        ckpt = os.path.join(create_exp_dir(args.exp_root, f"{name}-{args.exp_name}"), "ckpt")
    job = dict(name=name, args=args, shards=shards, n=n, ckpt=ckpt, graph=g,
               cfg=deeper_gcn_config(args, in_dim),
               x=shard_nodes(g.x[:n].numpy(), shards),
               labels=shard_nodes(labels[:, None], shards)[..., 0],
               mask=_rows(train, shards), score=partial(_accuracy, labels, splits))
    _report(f"[{name}] gp x tp: {D} x {T} shard={shards.shard_size} "
            f"halo_rows/rank/layer={shards.halo_rows_per_device} (rows of "
            f"{args.hidden_channels // T} channels) exchange={args.exchange}")
    return launch(_train_tp_ranks, D * T, (job,), device=args.device, deadline=DEADLINE_S,
                  threads=1 if args.device == "cpu" else 0)[0]
