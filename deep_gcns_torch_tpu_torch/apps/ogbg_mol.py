"""DeeperGCN on ogbg-mol* — graph property prediction (molhiv / molpcba);
counterpart of `examples/ogbg_mol/main.py`.

    python -m deep_gcns_torch_tpu_torch.apps.ogbg_mol --synthetic \\
        [--learn_t] [--num_layers 14 --add_virtual_node --num_tasks 128] \\
        [--epochs E] [--device cuda|cpu] [--save_ckpt]

The defaults are the JAX app's: DyResGEN-7 with ``--learn_t`` (res+, softmax
at t=1.0, batch norm, C=256, a BondEncoder in every layer, mean pooling,
dropout 0.5, Adam 0.01, batches of 32 molecules; the molhiv headline), and
ResGEN-14 with the virtual node for molpcba (``--num_layers 14
--add_virtual_node --num_tasks 128``). The AtomEncoder embeds the 9 integer
atom features; the loss is the NaN-masked BCE on logits (`is_labeled`); the
score ROC-AUC with one task, else average precision. ``--grad_clip`` clips
every gradient entry to [-v, v] (optax's `clip`, a value clip).
``--conv_encode_edge`` is on by default, as in the JAX app (one BondEncoder
at the model level otherwise). Like the JAX app, ``--compute_dtype`` and
``--remat`` are not passed to the model: it runs in float32.

The data is the JAX app's synthetic molecule list, made from ``--seed``
draw for draw: 200 molecules of 10-29 atoms with 3n bonds, labelled by a
random linear score of their atoms against its median, 80/20 split; with
more tasks each label is repeated and 20 % of them set to NaN. Batches are
block-diagonal with one fixed node and edge pad (`make_batcher`).

The evaluation scores every test molecule: the last partial batch is padded
with copies of the last molecule and trimmed after the forward, as the test
script does (`apps/ogbg_mol_test.py`), so that the script reproduces the
score of the epoch it loads. With ``--save_ckpt`` a new best score writes
`{exp}/ckpt_best`.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.ogb_features import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
from ..device import resolve_device
from ..graph import Graph, batch_graphs
from ..models import DeeperGCN, DeeperGCNConfig
from ..utils.ckpt import save_ckpt
from ..utils.loss import bce_with_logits
from ..utils.metrics import average_precision, roc_auc
from .common import (EpochTimer, add_deeper_gcn_flags, base_parser, make_optimizer,
                     open_experiment, report)


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeeperGCN on ogbg-mol (PyTorch/CUDA)")
    add_deeper_gcn_flags(p, num_layers=7, hidden=256, norm="batch", t=1.0, aggr="softmax")
    p.add_argument("--dataset", type=str, default="ogbg-molhiv")
    p.add_argument("--num_tasks", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--graph_pooling", type=str, default="mean")
    p.add_argument("--add_virtual_node", action="store_true")
    p.add_argument("--conv_encode_edge", action="store_true", default=True)
    p.add_argument("--grad_clip", type=float, default=0.0)
    p.set_defaults(epochs=300, lr=0.01, dropout=0.5)
    return p.parse_args(argv)


def load_mol(args, rng: np.random.Generator) -> Tuple[List[dict], List[dict]]:
    """(train, test) molecule lists, each a dict of x int [n, 9], senders,
    receivers, edge_attr int [e, 3] and y float [num_tasks] (NaN where
    unlabelled); the JAX app's draws (`examples/ogbg_mol/main.py:32-62`)."""
    if not args.synthetic:
        raise FileNotFoundError("ogbg-mol requires a local cache; pass --synthetic")
    gs, scores = [], []
    w = rng.standard_normal((len(ATOM_FEATURE_DIMS),)).astype(np.float32)
    for _ in range(200):
        n = int(rng.integers(10, 30))
        e = n * 3
        x = np.stack([rng.integers(0, d, n) for d in ATOM_FEATURE_DIMS], 1)
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
        ea = np.stack([rng.integers(0, d, e) for d in BOND_FEATURE_DIMS], 1)
        scores.append(float((x @ w).mean()))
        gs.append(dict(x=x.astype(np.int32), senders=s, receivers=r,
                       edge_attr=ea.astype(np.int32)))
    med = float(np.median(scores))
    for g, sc in zip(gs, scores):
        y = np.array([sc > med], np.float32)
        if args.num_tasks > 1:
            y = np.repeat(y, args.num_tasks)
            y[rng.random(args.num_tasks) < 0.2] = np.nan  # is_labeled mask
        g["y"] = y
    n_tr = int(0.8 * len(gs))
    return gs[:n_tr], gs[n_tr:]


def build_model(args, generator: Optional[torch.Generator] = None) -> DeeperGCN:
    return DeeperGCN(DeeperGCNConfig(
        in_channels=0, hidden_channels=args.hidden_channels, num_tasks=args.num_tasks,
        num_layers=args.num_layers, block=args.block, aggr=args.gcn_aggr, t=args.t,
        learn_t=args.learn_t, p=args.p, learn_p=args.learn_p, msg_norm=args.msg_norm,
        learn_msg_scale=args.learn_msg_scale, norm=args.norm, mlp_layers=args.mlp_layers,
        dropout=args.dropout, node_encoder="atom", atom_feature_dims=ATOM_FEATURE_DIMS,
        edge_mode="bond" if args.conv_encode_edge else "one_time_bond",
        bond_feature_dims=BOND_FEATURE_DIMS, graph_pooling=args.graph_pooling,
        add_virtual_node=args.add_virtual_node, final_relu=False), generator=generator)


def make_batcher(batch_size: int, all_gs: Sequence[dict],
                 label: Callable[[dict], np.ndarray] = lambda g: g["y"]
                 ) -> Callable[[Sequence[dict]], Tuple[Graph, torch.Tensor]]:
    """Block-diagonal batches padded to one fixed bucket: nodes to the
    largest molecule times the batch size rounded up to 256, edges likewise
    to 512 (`examples/ogbg_mol/main.py:84-102`). Returns (host Graph, labels
    stacked by ``label``)."""
    node_pad = ((max(g["x"].shape[0] for g in all_gs) * batch_size + 255) // 256) * 256
    edge_pad = ((max(len(g["senders"]) for g in all_gs) * batch_size + 511) // 512) * 512

    def make_batch(gs: Sequence[dict]):
        gr = batch_graphs([dict(x=g["x"], senders=g["senders"], receivers=g["receivers"],
                                edge_attr=g["edge_attr"]) for g in gs],
                          node_pad=node_pad, edge_pad=edge_pad)
        return gr, torch.from_numpy(np.stack([label(g) for g in gs]))

    return make_batch


def train_step(model: DeeperGCN, opt: torch.optim.Optimizer, g: Graph, y: torch.Tensor,
               generator: Optional[torch.Generator], grad_clip: float = 0.0) -> torch.Tensor:
    """One batch: NaN-masked BCE (`examples/ogbg_mol/main.py:127, 134-135`), the
    value clip, the update. Returns the loss (still on the device)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = bce_with_logits(model(g.x, g, generator), y, ~torch.isnan(y))
    loss.backward()
    if grad_clip:
        torch.nn.utils.clip_grad_value_(model.parameters(), grad_clip)
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict(model: DeeperGCN, g: Graph) -> torch.Tensor:
    model.eval()
    return model(g.x, g)


def predict_all(model: torch.nn.Module, gs: Sequence[dict], batch_size: int, make_batch,
                dev: torch.device, predict_fn: Callable = predict) -> Tuple[np.ndarray,
                                                                          np.ndarray]:
    """Outputs and labels of every graph of ``gs`` in batches of
    ``batch_size``: the last batch is padded with copies of the last graph
    and the copies' rows trimmed (`examples/ogbg_mol/test.py:45-54`)."""
    n_true = len(gs)
    padded = list(gs) + [gs[-1]] * ((-n_true) % batch_size)
    preds, ys = [], []
    for i in range(0, len(padded), batch_size):
        gr, y = make_batch(padded[i: i + batch_size])
        preds.append(predict_fn(model, gr.to(dev)).float().cpu().numpy())
        ys.append(y.numpy())
    return np.concatenate(preds)[:n_true], np.concatenate(ys)[:n_true]


def score(args, preds: np.ndarray, ys: np.ndarray) -> float:
    """ROC-AUC with one task, else average precision."""
    return (roc_auc if args.num_tasks == 1 else average_precision)(preds, ys)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the best score, every epoch's mean loss and score, and
    the experiment directory (None without ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    train_gs, test_gs = load_mol(args, rng)
    B = args.batch_size
    make_batch = make_batcher(B, train_gs + test_gs)
    model = build_model(args, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args, model.parameters())
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "ogbg_mol")
    timer, best, losses, scores = EpochTimer(), -math.inf, [], []
    for epoch in range(args.epochs):
        order = rng.permutation(len(train_gs))
        ep = []
        for i in range(0, len(order) - B + 1, B):
            gr, y = make_batch([train_gs[j] for j in order[i: i + B]])
            ep.append(train_step(model, opt, gr.to(dev), y.to(dev), drop_gen, args.grad_clip))
        loss = float(torch.stack(ep).mean())
        m = score(args, *predict_all(model, test_gs, B, make_batch, dev))
        losses.append(loss)
        scores.append(m)
        if m > best:
            best = m
            if exp is not None:
                save_ckpt(f"{exp}/ckpt_best", model=model, epoch=epoch, best_value=best)
        report(logger, f"epoch {epoch} loss {loss:.4f} metric {m:.4f} ({timer.lap():.1f}s)")
        if scalars is not None:
            scalars.log(epoch, loss=loss, metric=m)
    report(logger, f"best metric {best:.4f}")
    return {"best": best, "losses": losses, "scores": scores, "exp": exp}


if __name__ == "__main__":
    main()
