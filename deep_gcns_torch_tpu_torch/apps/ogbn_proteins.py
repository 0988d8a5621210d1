"""DeeperGCN on ogbn-proteins: cluster training, multi-partition evaluation
(counterpart of `examples/ogbn_proteins/main.py:1-54`).

    python -m deep_gcns_torch_tpu_torch.apps.ogbn_proteins --synthetic --learn_t \\
        [--synthetic_nodes N] [--epochs E] [--compute_dtype bfloat16] [--device cuda|cpu]

The defaults are the JAX app's: res+, softmax at t=1.0, layer norm, C=64,
112 layers, a one-layer MLP, dropout 0.1, per-layer edge encoders, the
one-hot species encoder and no final dropout; with ``--learn_t`` this is
DyResGEN-112, the DeeperGCN proteins headline. Adam at lr 0.01 after the
global-norm clip at 1.0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models import DeeperGCN, DeeperGCNConfig
from .proteins_common import base_parser, predict, run_proteins, train_step

__all__ = ["build_model", "get_args", "main", "predict", "train_step"]


def get_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("DeeperGCN on ogbn-proteins (PyTorch/CUDA)", num_layers=112, hidden=64,
                    epochs=1000, lr=0.01)
    return p.parse_args(argv)


def build_model(args, generator: Optional[torch.Generator] = None) -> DeeperGCN:
    return DeeperGCN(DeeperGCNConfig(
        in_channels=8, hidden_channels=args.hidden_channels, num_tasks=args.num_tasks,
        num_layers=args.num_layers, block=args.block, aggr=args.gcn_aggr, t=args.t,
        learn_t=args.learn_t, p=args.p, learn_p=args.learn_p, y=args.y,
        learn_y=args.learn_y, msg_norm=args.msg_norm, learn_msg_scale=args.learn_msg_scale,
        norm=args.norm, mlp_layers=args.mlp_layers, dropout=args.dropout,
        edge_mode="per_layer" if args.conv_encode_edge else "one_time", edge_feat_dim=8,
        use_one_hot_encoding=args.use_one_hot_encoding, node_feat_dim=8,
        final_dropout=False, compute_dtype=args.compute_dtype, remat=args.remat),
        generator=generator)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run_proteins(get_args(argv), build_model, "ogbn_proteins")


if __name__ == "__main__":
    main()
