"""DeepGCN on PPI: static-graph multi-label node classification
(counterpart of `examples/ppi/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.ppi --synthetic \\
        [--epochs E] [--device cuda|cpu] [--save_ckpt]

The defaults are the JAX app's ResMRGCN-14: 14 res blocks of MRConv at 64
channels, batch norm, relu, dropout 0.2 between the prediction MLPs; 50
input features and 121 labels; BCE with logits under the node mask, Adam at
lr 0.002, `ReduceLROnPlateau` (mode max, patience ``--lr_patience``) on the
valid micro-F1. ``--compute_dtype bfloat16`` runs MRConv/EdgeConv's edge
path in bf16 with float32 accumulation.

Data: ``--synthetic`` draws the JAX app's graphs from ``--seed`` draw for
draw (8 train, 2 valid and 2 test graphs of 200-399 nodes, 12 random
in-edges a node on average, labels the sign of a random map of the summed
neighbour features); otherwise `{data_root}/ppi.npz`, converted from the
GraphSAGE raw layout in `{data_root}/ppi_raw` when only that is there
(`data/ppi.py`). Every graph is padded to one fixed bucket (`make_batcher`),
one graph a step. With ``--save_ckpt`` a new best valid micro-F1 writes
`{exp}/ckpt_best`, which `apps/ppi_test.py` scores.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph import Graph, batch_graphs
from ..models import DeepGCNConfig, DeepGCNStatic
from ..utils.ckpt import save_ckpt
from ..utils.loss import bce_with_logits
from ..utils.metrics import micro_f1
from ..utils.optim import ReduceLROnPlateau
from .common import EpochTimer, base_parser, make_optimizer, open_experiment, report


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeepGCN on PPI (PyTorch/CUDA)")
    p.add_argument("--block", type=str, default="res")
    p.add_argument("--conv", type=str, default="mr")
    p.add_argument("--compute_dtype", type=str, default="",
                   help="e.g. bfloat16: bf16 edge path, f32 accumulation")
    p.add_argument("--norm", type=str, default="batch")
    p.add_argument("--act", type=str, default="relu")
    p.add_argument("--n_blocks", type=int, default=14)
    p.add_argument("--n_filters", type=int, default=64)
    p.add_argument("--n_heads", type=int, default=1)
    p.add_argument("--in_channels", type=int, default=50)
    p.add_argument("--n_classes", type=int, default=121)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr_patience", type=int, default=10)
    p.set_defaults(epochs=2000, lr=0.002, dropout=0.2)
    return p.parse_args(argv)


def load_ppi(args, rng: np.random.Generator) -> Tuple[List[dict], List[dict], List[dict]]:
    """(train, valid, test) graph lists (`load_ppi`, `examples/ppi/main.py:
    35-73`)."""
    if args.synthetic:
        def make(n_graphs):
            gs = []
            for _ in range(n_graphs):
                n = int(rng.integers(200, 400))
                e = n * 12
                s = rng.integers(0, n, e)
                r = rng.integers(0, n, e)
                x = rng.standard_normal((n, args.in_channels)).astype(np.float32)
                agg = np.zeros_like(x)
                np.add.at(agg, r, x[s])
                y = ((agg @ w) > 0).astype(np.float32)
                gs.append(dict(x=x, senders=s, receivers=r, y=y))
            return gs

        w = rng.standard_normal((args.in_channels, args.n_classes)).astype(np.float32)
        return make(8), make(2), make(2)
    path = os.path.join(args.data_root, "ppi.npz")
    if not os.path.exists(path):
        raw = os.path.join(args.data_root, "ppi_raw")
        if not os.path.exists(os.path.join(raw, "train_graph.json")):
            raise FileNotFoundError(
                f"no PPI cache at {path}; convert a raw copy with `python -m "
                f"deep_gcns_torch_tpu_torch.data.ppi <raw_dir> {path}` or pass --synthetic")
        from ..data.ppi import convert_ppi_raw

        convert_ppi_raw(raw, path)
    z = np.load(path, allow_pickle=True)
    return list(z["train"]), list(z["valid"]), list(z["test"])


def build_model(args, generator: Optional[torch.Generator] = None) -> DeepGCNStatic:
    return DeepGCNStatic(DeepGCNConfig(
        in_channels=args.in_channels, n_classes=args.n_classes, n_filters=args.n_filters,
        n_blocks=args.n_blocks, conv=args.conv, compute_dtype=args.compute_dtype or None,
        act=args.act, norm=args.norm, heads=args.n_heads, block=args.block,
        dropout=args.dropout), generator=generator)


def make_batcher(args, all_gs: Sequence[dict]) -> Callable[[dict], Tuple[Graph, torch.Tensor]]:
    """One fixed bucket for every graph: nodes padded to a multiple of 256 of
    the largest graph's, edges to a multiple of 512; returns
    g -> (Graph, labels [node_pad, n_classes]) on the host."""
    max_n = max(g["x"].shape[0] for g in all_gs)
    max_e = max(len(g["senders"]) for g in all_gs)
    node_pad = ((max_n + 255) // 256) * 256
    edge_pad = ((max_e + 511) // 512) * 512

    def to_batch(g: dict) -> Tuple[Graph, torch.Tensor]:
        gr = batch_graphs([dict(x=g["x"], senders=g["senders"], receivers=g["receivers"])],
                          node_pad=node_pad, edge_pad=edge_pad)
        y = np.zeros((node_pad, args.n_classes), np.float32)
        y[: len(g["y"])] = g["y"]
        return gr, torch.from_numpy(y)

    return to_batch


def train_step(model: DeepGCNStatic, opt: torch.optim.Optimizer, g: Graph, y: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One graph of BCE with logits under the node mask; returns the loss
    (still on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = bce_with_logits(model(g.x, g, generator), y, mask=g.node_mask)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: DeepGCNStatic, g: Graph) -> torch.Tensor:
    """Logits [N_pad, n_classes] in eval mode."""
    model.eval()
    return model(g.x, g)


def evaluate(model: DeepGCNStatic, gs: Sequence[dict], to_batch, dev: torch.device) -> float:
    """Micro-F1 over every node of ``gs``."""
    preds = []
    for g in gs:
        gr, _ = to_batch(g)
        preds.append(predict(model, gr.to(dev))[: g["x"].shape[0]].float().cpu().numpy())
    return micro_f1(np.concatenate(preds), np.concatenate([g["y"] for g in gs]))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the best valid and test micro-F1, every epoch's mean
    loss and valid micro-F1, and the experiment directory (None without
    ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    train_gs, valid_gs, test_gs = load_ppi(args, rng)
    to_batch = make_batcher(args, train_gs + valid_gs + test_gs)
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args, model.parameters())
    plateau = ReduceLROnPlateau(patience=args.lr_patience, mode="max")
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "ppi")
    timer, best_valid, best_test, losses, f1s = EpochTimer(), -math.inf, -math.inf, [], []
    for epoch in range(args.epochs):
        ep = []
        for gi in rng.permutation(len(train_gs)):
            gr, y = to_batch(train_gs[gi])
            ep.append(train_step(model, opt, gr.to(dev), y.to(dev), drop_gen))
        loss = float(torch.stack(ep).mean())
        f1_v = evaluate(model, valid_gs, to_batch, dev)
        f1_t = evaluate(model, test_gs, to_batch, dev)
        scale = plateau.step(f1_v)
        for group in opt.param_groups:
            group["lr"] = args.lr * scale
        losses.append(loss)
        f1s.append(f1_v)
        if f1_v > best_valid:
            best_valid = f1_v
            if exp is not None:
                save_ckpt(f"{exp}/ckpt_best", model=model, epoch=epoch, best_value=best_valid)
        best_test = max(best_test, f1_t)
        report(logger, f"epoch {epoch} loss {loss:.4f} valid-F1 {f1_v:.4f} test-F1 {f1_t:.4f} "
                       f"lr {args.lr * scale:.5f} ({timer.lap():.1f}s)")
        if scalars is not None:
            scalars.log(epoch, loss=loss, f1_valid=f1_v, f1_test=f1_t)
    report(logger, f"best valid F1 {best_valid:.4f} best test F1 {best_test:.4f}")
    return {"best": best_valid, "best_test": best_test, "losses": losses, "f1_valid": f1s,
            "exp": exp}


if __name__ == "__main__":
    main()
