"""RevGCN (GNN-1000) on ogbn-proteins: O(1)-activation-memory reversible
training on clusters (counterpart of `examples/ogb_eff/ogbn_proteins/main.py`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_proteins_rev --synthetic \\
        [--num_layers L] [--epochs E] [--compute_dtype bfloat16] [--device cuda|cpu]

The defaults are the JAX app's RevGNN-Deep: 1001 layers of 80 channels in
2 groups of 40, GENConv softmax at t=1.0 (not learned), layer norm, a
one-layer MLP, dropout 0.1 (one shared mask a forward), conv-level edge
encoders and the one-hot species encoder; Adam at lr 0.001 after the
global-norm clip at 1.0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models import RevGCN, RevGCNConfig
from .proteins_common import base_parser, predict, run_proteins, train_step

__all__ = ["build_model", "get_args", "main", "predict", "train_step"]


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("RevGCN on ogbn-proteins (PyTorch/CUDA)", num_layers=1001, hidden=80,
                    epochs=2000, lr=0.001)
    p.add_argument("--group", type=int, default=2)
    return p.parse_args(argv)


def build_model(args, generator: Optional[torch.Generator] = None) -> RevGCN:
    return RevGCN(RevGCNConfig(
        in_channels=8, node_feat_dim=8, edge_feat_dim=8,
        hidden_channels=args.hidden_channels, num_tasks=args.num_tasks,
        num_layers=args.num_layers, group=args.group, aggr=args.gcn_aggr, t=args.t,
        learn_t=args.learn_t, p=args.p, learn_p=args.learn_p, y=args.y,
        learn_y=args.learn_y, msg_norm=args.msg_norm, learn_msg_scale=args.learn_msg_scale,
        conv_encode_edge=args.conv_encode_edge, norm=args.norm,
        mlp_layers=args.mlp_layers, dropout=args.dropout,
        use_one_hot_encoding=args.use_one_hot_encoding,
        compute_dtype=args.compute_dtype), generator=generator)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run_proteins(get_args(argv), build_model, "ogbn_proteins_rev")


if __name__ == "__main__":
    main()
