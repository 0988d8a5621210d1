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
``--band_hubs off`` builds the band without hub structures.

The synthetic SBM task is the only data source; the student mode (it needs
checkpoints) and real OGB loading raise `NotImplementedError`.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.synthetic import sbm_arxiv_like
from ..device import resolve_device
from ..graph import Graph
from ..models import RevGAT, RevGATConfig
from ..utils.loss import cross_entropy
from ..utils.metrics import accuracy
from ..utils.optim import linear_schedule, make_optimizer
from .ogbn_arxiv import reorder_and_band


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RevGAT on ogbn-arxiv with label reuse "
                                            "(PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--dropout", type=float, default=0.75)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic SBM stand-in (the only data source of this slice)")
    p.add_argument("--synthetic_nodes", type=int, default=4096)
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
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One full-batch step with the loss on the ``sup_mask`` rows; returns
    the loss (still on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = cross_entropy(model(feat, g, generator), labels, sup_mask)
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
    args = get_args(argv)
    if args.mode == "student":
        raise NotImplementedError("--mode student needs teacher checkpoints, which come "
                                  "with a later slice")
    if not args.synthetic:
        raise NotImplementedError("OGB dataset loading is not ported yet; pass --synthetic")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    n, k = args.synthetic_nodes, args.num_classes
    g, labels = sbm_arxiv_like(rng, n=n, num_classes=k, c=128, avg_degree=12)
    perm = rng.permutation(n)
    splits = {"train": perm[: int(0.6 * n)], "valid": perm[int(0.6 * n): int(0.8 * n)],
              "test": perm[int(0.8 * n):]}
    g, labels, splits = reorder_and_band(args, g, labels, splits)
    g = g.to(dev)
    n_pad = g.num_nodes_padded
    lab = torch.zeros(n_pad, dtype=torch.long)
    lab[:n] = torch.from_numpy(np.asarray(labels))
    lab = lab.to(dev)
    onehot = torch.nn.functional.one_hot(lab, k).float() if args.use_labels else None
    x_base = g.x

    model = build_model(args, x_base.shape[1], torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer("rmsprop", model.parameters(), 1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, linear_schedule(args.lr / 50, args.lr, args.warmup_epochs))
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    train_idx = np.asarray(splits["train"])
    eval_mask = torch.zeros(n_pad, dtype=torch.bool)
    eval_mask[torch.from_numpy(train_idx)] = True
    eval_mask = eval_mask.to(dev)
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
        loss_t = train_step(model, opt, sched, g, feat, lab, sm, drop_gen)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            pred = predict(model, g, x_base, onehot, eval_mask,
                           args.n_label_iters).argmax(-1).cpu().numpy()
            accs = {name: accuracy(pred[v], np.asarray(labels)[v])
                    for name, v in splits.items()}
            loss = float(loss_t)
            print(f"epoch {epoch} loss {loss:.4f} train {accs['train']:.4f} "
                  f"valid {accs['valid']:.4f} test {accs['test']:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
            if accs["valid"] > best_valid:
                best_valid, best_test = accs["valid"], accs["test"]
    return {"loss": loss, "best_valid": best_valid, "best_test": best_test}


if __name__ == "__main__":
    main()
