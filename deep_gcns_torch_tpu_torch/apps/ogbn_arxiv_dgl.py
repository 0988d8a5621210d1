"""RevGAT on an ogbn-arxiv-shaped task with label reuse, teacher mode
(counterpart of `examples/ogb_eff/ogbn_arxiv_dgl/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_arxiv_dgl --synthetic \\
        [--synthetic_nodes N] [--epochs E] [--device cuda|cpu] \\
        [--reorder none|rcm|cluster] [--band off|auto] [--band_hubs auto|off] \\
        [--use_attn_dst] [--gat_stabilizer auto|per_receiver] [--compute_dtype bfloat16]

Same defaults as the JAX app: RevGAT-5L, 256 hidden x 3 heads, group 2,
dropout 0.75, input dropout 0.25, edge-drop 0.3, sender-only scores,
symmetric norm; torch-exact RMSprop (lr 0.002) with a linear warm-up from
lr/50 over 50 epochs. The input is the node features and, with label reuse,
the one-hot labels of a random half of the training nodes, drawn anew every
epoch (``--mask_rate``); the loss is taken on the other half. `predict` feeds
its argmax predictions back into the label channel ``--n_label_iters``
times. With a band attached (``--reorder cluster --band auto``) the GAT
aggregation takes the band route, otherwise the CSC route (K5/K6). With a
band, destination scores (``--use_attn_dst``) and the exact per-receiver
stabilizer (``--gat_stabilizer per_receiver``) take the dense route (K7–K9);
``--band_hubs off`` builds the band without hub structures. Without
``--synthetic`` the graph is ogbn-arxiv from the local cache (as
`apps/ogbn_arxiv.py` loads it).

Checkpoints (`main.py:125-128, 146-153, 181-183, 208-213` of the JAX app):
with ``--save_ckpt`` a run saves `{exp_root}/revgat_{mode}-{exp_name}-…/ckpt`
at every new best validation accuracy (the JAX teacher saves without the
flag too). ``--mode student --teacher_ckpt PREFIX`` loads a teacher of the
same shape, takes its evaluation logits (with label reuse and refinement,
as `predict` computes them) once, and trains a fresh student on
``alpha`` · kd_loss(student, teacher, ``temp``) + (1 − ``alpha``) · cross
entropy, both on the supervised rows.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..graph import Graph
from ..models import RevGAT, RevGATConfig
from ..utils.ckpt import load_ckpt, save_ckpt
from ..utils.logger import create_exp_dir
from ..utils.loss import cross_entropy, kd_loss
from ..utils.metrics import accuracy
from ..utils.optim import linear_schedule, make_optimizer
from .ogbn_arxiv import load_data


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RevGAT on ogbn-arxiv with label reuse "
                                            "(PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--dropout", type=float, default=0.75)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic SBM stand-in for ogbn-arxiv")
    p.add_argument("--synthetic_nodes", type=int, default=4096)
    p.add_argument("--data_root", type=str, default="data/")
    p.add_argument("--exp_root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--save_ckpt", action="store_true",
                   help="save a checkpoint at every new best validation accuracy")
    p.add_argument("--n_layers", type=int, default=5)
    p.add_argument("--n_hidden", type=int, default=256)
    p.add_argument("--n_heads", type=int, default=3)
    p.add_argument("--group", type=int, default=2)
    p.add_argument("--input_drop", type=float, default=0.25)
    p.add_argument("--edge_drop", type=float, default=0.3)
    p.add_argument("--use_attn_dst", action="store_true")
    p.add_argument("--gat_stabilizer", type=str, default="auto",
                   choices=["auto", "per_receiver"],
                   help="softmax stabilizer of sender-only scores: 'per_receiver' is "
                        "exact on wide score spreads (the dense route with a band)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--no_norm_adj", action="store_true", help="disable symmetric norm")
    p.add_argument("--use_labels", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--n_label_iters", type=int, default=1)
    p.add_argument("--mask_rate", type=float, default=0.5)
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--warmup_epochs", type=int, default=50)
    p.add_argument("--mode", type=str, default="teacher", choices=["teacher", "student"])
    p.add_argument("--teacher_ckpt", type=str, default="",
                   help="the teacher's checkpoint prefix (student mode)")
    p.add_argument("--alpha", type=float, default=0.95, help="weight of the distillation loss")
    p.add_argument("--temp", type=float, default=0.7, help="distillation temperature")
    p.add_argument("--reorder", type=str, default="none", choices=["none", "rcm", "cluster"])
    p.add_argument("--band", type=str, default="off", choices=["off", "auto"])
    p.add_argument("--band_hubs", type=str, default="auto", choices=["auto", "off"],
                   help="hub extraction for the band; 'off' builds a hub-free band")
    return p.parse_args(argv)


def build_model(args, in_feats: int, generator: Optional[torch.Generator] = None) -> RevGAT:
    k = args.num_classes
    return RevGAT(RevGATConfig(
        in_feats=in_feats + (k if args.use_labels else 0), n_classes=k,
        n_hidden=args.n_hidden, n_layers=args.n_layers, n_heads=args.n_heads,
        group=args.group, dropout=args.dropout, input_drop=args.input_drop,
        edge_drop=args.edge_drop, use_attn_dst=args.use_attn_dst,
        use_symmetric_norm=not args.no_norm_adj, compute_dtype=args.compute_dtype,
        stabilizer=args.gat_stabilizer), generator=generator)


def make_features(x_base: torch.Tensor, onehot: Optional[torch.Tensor],
                  label_mask: torch.Tensor,
                  soft: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[x | one-hot labels of the ``label_mask`` rows, else ``soft`` (0 when
    None)]; x alone without label reuse (``onehot`` None)."""
    if onehot is None:
        return x_base
    other = torch.zeros_like(onehot) if soft is None else soft
    return torch.cat([x_base, torch.where(label_mask[:, None], onehot, other)], 1)


def train_step(model: RevGAT, opt: torch.optim.Optimizer,
               sched: torch.optim.lr_scheduler.LRScheduler, g: Graph, feat: torch.Tensor,
               labels: torch.Tensor, sup_mask: torch.Tensor,
               generator: Optional[torch.Generator],
               teacher_logits: Optional[torch.Tensor] = None, alpha: float = 0.95,
               temp: float = 0.7) -> torch.Tensor:
    """One full-batch step with the loss on the ``sup_mask`` rows (with
    ``teacher_logits``, the distillation mix); returns the loss (still on
    the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = model(feat, g, generator)
    loss = cross_entropy(logits, labels, sup_mask)
    if teacher_logits is not None:
        loss = (alpha * kd_loss(logits, teacher_logits, temp, mask=sup_mask)
                + (1 - alpha) * loss)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


@torch.no_grad()
def predict(model: RevGAT, g: Graph, x_base: torch.Tensor, onehot: Optional[torch.Tensor],
            label_mask: torch.Tensor, n_label_iters: int) -> torch.Tensor:
    """Logits with the ``label_mask`` rows' labels as input, refined
    ``n_label_iters`` times by feeding the argmax of the other rows back
    (`main.py:151-161`)."""
    model.eval()
    logits = model(make_features(x_base, onehot, label_mask), g)
    if onehot is not None:
        for _ in range(n_label_iters):
            soft = torch.nn.functional.one_hot(logits.argmax(-1), onehot.shape[1])
            logits = model(make_features(x_base, onehot, label_mask, soft.to(onehot.dtype)), g)
    return logits


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the last printed loss, the best validation and its
    test accuracy, and the checkpoint prefix (None without ``--save_ckpt``)."""
    args = get_args(argv)
    if args.mode == "student" and not args.teacher_ckpt:
        raise ValueError("--mode student needs --teacher_ckpt")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    g, labels, splits, in_feats = load_data(args, rng)
    n, k = g.n_node, args.num_classes
    g = g.to(dev)
    n_pad = g.num_nodes_padded
    lab = torch.zeros(n_pad, dtype=torch.long)
    lab[:n] = torch.from_numpy(labels)
    lab = lab.to(dev)
    onehot = torch.nn.functional.one_hot(lab, k).float() if args.use_labels else None
    x_base = g.x

    model = build_model(args, in_feats, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer("rmsprop", model.parameters(), 1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, linear_schedule(args.lr / 50, args.lr, args.warmup_epochs))
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    train_idx = np.asarray(splits["train"])
    eval_mask = torch.zeros(n_pad, dtype=torch.bool)
    eval_mask[torch.from_numpy(train_idx)] = True
    eval_mask = eval_mask.to(dev)
    teacher_logits = None
    if args.mode == "student":
        teacher = build_model(args, in_feats).to(dev)
        load_ckpt(args.teacher_ckpt, model=teacher)
        teacher_logits = predict(teacher, g, x_base, onehot, eval_mask, args.n_label_iters)
        del teacher
    ckpt_path = None
    if args.save_ckpt:
        ckpt_path = os.path.join(
            create_exp_dir(args.exp_root, f"revgat_{args.mode}-{args.exp_name}"), "ckpt")
    best_valid = best_test = -1.0
    loss, t0 = float("nan"), time.time()
    for epoch in range(args.epochs):
        # the per-epoch split of the training nodes into label input and
        # supervision (`main.py:136-143`)
        sel = rng.random(len(train_idx)) < args.mask_rate
        lm = torch.zeros(n_pad, dtype=torch.bool)
        lm[torch.from_numpy(train_idx[sel])] = True
        sm = torch.zeros(n_pad, dtype=torch.bool)
        sm[torch.from_numpy(train_idx[~sel])] = True
        lm, sm = lm.to(dev), sm.to(dev)
        feat = make_features(x_base, onehot, lm)
        loss_t = train_step(model, opt, sched, g, feat, lab, sm, drop_gen, teacher_logits,
                            args.alpha, args.temp)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            pred = predict(model, g, x_base, onehot, eval_mask,
                           args.n_label_iters).argmax(-1).cpu().numpy()
            accs = {name: accuracy(pred[v], labels[v]) for name, v in splits.items()}
            loss = float(loss_t)
            print(f"epoch {epoch} loss {loss:.4f} train {accs['train']:.4f} "
                  f"valid {accs['valid']:.4f} test {accs['test']:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
            if accs["valid"] > best_valid:
                best_valid, best_test = accs["valid"], accs["test"]
                if ckpt_path:
                    save_ckpt(ckpt_path, model=model, epoch=epoch, best_value=best_valid)
    return {"loss": loss, "best_valid": best_valid, "best_test": best_test, "ckpt": ckpt_path}


if __name__ == "__main__":
    main()
