"""DeeperGCN + LinkPredictor on ogbl-collab — link prediction with Hits@K
(counterpart of `examples/ogbl_collab/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbl_collab --synthetic \\
        [--synthetic_nodes N] [--epochs E] [--device cuda|cpu] [--save_ckpt]

The defaults are the JAX app's: a DeeperGCN encoder (res+, softmax at t=1.0,
batch norm, 3 layers, C=64, no dropout) whose output is the node embedding
(``num_tasks`` = C), and a 3-layer `LinkPredictor` scoring sigmoid(MLP(h_i ⊙
h_j)). One update an epoch on ``--batch_edges`` random training edges and
as many uniform random negatives: the pos/neg log loss, the global-norm clip
at 1.0 chained before the optimizer (Adam at lr 0.001). Hits@``--hits_k``
of the held-out positive edges against random negatives every 5 epochs and
at the last (`examples/ogbl_collab/main.py:118-141`). As in the JAX app,
``--compute_dtype`` and ``--remat`` are not passed to the model.

The data is the JAX app's, made from ``--seed`` draw for draw: the
synthetic SBM (8 classes, 64 features, average degree 8, made undirected
with self-loops) as the message-passing graph, its edges split 10/90 into
held-out and training positives. The evaluation's negatives are drawn once,
right after the data, and reused at every evaluation (OGB's collab has a
fixed negative set too; the JAX app draws new ones at each evaluation), so
that `apps/ogbl_collab_test.py` reproduces the Hits@K of the epoch it
loads. With ``--save_ckpt`` a new best writes `{exp}/ckpt_best`, the
encoder under `model.` and the predictor under `predictor.`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.synthetic import sbm_arxiv_like
from ..device import resolve_device
from ..graph import Graph
from ..models import DeeperGCN, DeeperGCNConfig, LinkPredictor
from ..utils.ckpt import save_ckpt
from ..utils.metrics import hits_at_k
from ..utils.optim import clip_grad_global_norm_
from .common import (EpochTimer, add_deeper_gcn_flags, base_parser, make_optimizer,
                     open_experiment, report)

MAX_GRAD_NORM = 1.0  # optax.clip_by_global_norm(1.0) of the JAX app


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeeperGCN on ogbl-collab (PyTorch/CUDA)")
    add_deeper_gcn_flags(p, num_layers=3, hidden=64, norm="batch", t=1.0, aggr="softmax")
    p.add_argument("--lp_num_layers", type=int, default=3)
    p.add_argument("--lp_norm", type=str, default="none")
    p.add_argument("--num_tasks", type=int, default=1)
    p.add_argument("--hits_k", type=int, default=50)
    p.add_argument("--batch_edges", type=int, default=8192)
    p.set_defaults(epochs=400, lr=0.001, dropout=0.0)
    return p.parse_args(argv)


def load_data(args, rng: np.random.Generator):
    """(host graph, training positives, held-out positives, N, input width)
    (`examples/ogbl_collab/main.py:28-46`)."""
    if not args.synthetic:
        raise FileNotFoundError("ogbl-collab needs a local cache; pass --synthetic")
    n = args.synthetic_nodes
    g, _ = sbm_arxiv_like(rng, n=n, num_classes=8, c=64, avg_degree=8)
    em = g.edge_mask.numpy()
    s_all = g.senders.numpy()[em]
    r_all = g.receivers.numpy()[em]
    perm = rng.permutation(len(s_all))
    n_val = len(perm) // 10
    val_pos = (s_all[perm[:n_val]], r_all[perm[:n_val]])
    train_pos = (s_all[perm[n_val:]], r_all[perm[n_val:]])
    return g, train_pos, val_pos, n, 64


def eval_negatives(rng: np.random.Generator, n: int, count: int) -> Tuple[np.ndarray,
                                                                          np.ndarray]:
    """The evaluation's random negative edges, drawn once."""
    return rng.integers(0, n, count), rng.integers(0, n, count)


def build_models(args, in_dim: int, generator: Optional[torch.Generator] = None
                 ) -> torch.nn.ModuleDict:
    """{"model": the DeeperGCN encoder, "predictor": the LinkPredictor}."""
    model = DeeperGCN(DeeperGCNConfig(
        in_channels=in_dim, hidden_channels=args.hidden_channels,
        num_tasks=args.hidden_channels, num_layers=args.num_layers, block=args.block,
        aggr=args.gcn_aggr, t=args.t, learn_t=args.learn_t, norm=args.norm,
        mlp_layers=args.mlp_layers, dropout=args.dropout), generator=generator)
    predictor = LinkPredictor(args.hidden_channels, args.hidden_channels, 1,
                              args.lp_num_layers, args.lp_norm, args.dropout,
                              generator=generator)
    return torch.nn.ModuleDict({"model": model, "predictor": predictor})


def train_step(models: torch.nn.ModuleDict, opt: torch.optim.Optimizer, g: Graph,
               pos: Tuple[torch.Tensor, torch.Tensor], neg: Tuple[torch.Tensor, torch.Tensor],
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One update: the pos/neg log loss (`examples/ogbl_collab/main.py:88-104`), the
    global-norm clip, the optimizer. Returns the loss (on the device)."""
    models.train()
    opt.zero_grad(set_to_none=True)
    h = models["model"](g.x, g, generator)
    lp = models["predictor"]
    p = lp(h[pos[0]], h[pos[1]], generator)
    q = lp(h[neg[0]], h[neg[1]], generator)
    loss = -torch.log(p + 1e-15).mean() - torch.log(1 - q + 1e-15).mean()
    loss.backward()
    clip_grad_global_norm_(models.parameters(), MAX_GRAD_NORM)
    opt.step()
    return loss.detach()


@torch.no_grad()
def score(models: torch.nn.ModuleDict, g: Graph, edges: Sequence[Tuple[torch.Tensor,
                                                                       torch.Tensor]]):
    """Scores [E] of each (senders, receivers) pair of ``edges`` from one
    encoder forward."""
    models.eval()
    h = models["model"](g.x, g)
    return [models["predictor"](h[s], h[r])[:, 0] for s, r in edges]


def hits(args, models, g: Graph, val_pos, val_neg, dev: torch.device) -> float:
    pos, neg = score(models, g, [tuple(torch.from_numpy(a).to(dev) for a in val_pos),
                                 tuple(torch.from_numpy(a).to(dev) for a in val_neg)])
    return hits_at_k(pos.cpu().numpy(), neg.cpu().numpy(), args.hits_k)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the best Hits@K, every update's loss, the evaluated
    epochs' Hits@K and the experiment directory (None without
    ``--save_ckpt``)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    g, train_pos, val_pos, n, in_dim = load_data(args, rng)
    val_neg = eval_negatives(rng, n, len(val_pos[0]))
    g = g.to(dev)
    models = build_models(args, in_dim, torch.Generator().manual_seed(args.seed)).to(dev)
    opt = make_optimizer(args, models.parameters())
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    exp, logger, scalars = open_experiment(args, "ogbl_collab")
    timer, best, losses, evals = EpochTimer(), -math.inf, [], {}
    BE = min(args.batch_edges, len(train_pos[0]))
    for epoch in range(args.epochs):
        sel = rng.integers(0, len(train_pos[0]), BE)
        neg = (rng.integers(0, n, BE), rng.integers(0, n, BE))
        pos = (train_pos[0][sel], train_pos[1][sel])
        loss = train_step(models, opt, g, tuple(torch.from_numpy(a).to(dev) for a in pos),
                          tuple(torch.from_numpy(a).to(dev) for a in neg), drop_gen)
        losses.append(loss)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            h = hits(args, models, g, val_pos, val_neg, dev)
            evals[epoch] = h
            if h > best:
                best = h
                if exp is not None:
                    save_ckpt(f"{exp}/ckpt_best", model=models, epoch=epoch, best_value=best)
            report(logger, f"epoch {epoch} loss {float(loss):.4f} Hits@{args.hits_k} "
                           f"{h:.4f} ({timer.lap():.1f}s)")
            if scalars is not None:
                scalars.log(epoch, loss=float(loss), hits=h)
    report(logger, f"best Hits@{args.hits_k} {best:.4f}")
    return {"best": best, "losses": [float(v) for v in losses], "evals": evals, "exp": exp}


if __name__ == "__main__":
    main()
