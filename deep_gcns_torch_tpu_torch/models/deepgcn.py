"""DeepGCN on a static graph, the PPI model (counterpart of
`deep_gcns_torch_tpu/models/deepgcn.py:36-154`, reference
`examples/ppi/architecture.py:6-55`):

* a head `GraphConv` from the input features to ``n_filters`` channels;
* ``n_blocks`` − 1 res, plain or dense `GraphConv` blocks (dense blocks
  grow the width by ``n_filters`` each);
* multi-scale fusion: the head's and every block's output concatenated,
  MLP to 1024 channels, then the max over those CHANNELS per node ([N, 1],
  `architecture.py:53`), concatenated back;
* three prediction MLPs (to 512, 256, ``n_classes``) with dropout between
  them.

Parameter names are the reference's (`head.gconv.*`, `backbone.{i}.body.
gconv.*`, `fusion_block.*`, `prediction.{0,2,4}.*`), so a reference
checkpoint loads by name. The init is `kaiming_reinit` as in the JAX
package: every Linear and every PyG conv weight kaiming-normal, their biases
zero.

`SparseDeepGCN`, `DenseDeepGCN` and `DeepGCNCls` build kNN graphs on point
clouds and come with slice 9 (`ops/knn.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..convs.sparse import (DenseGraphBlock, GATConv, GCNConv, GraphConv, ResGraphBlock,
                            RSAGEConv)
from ..graph import Graph
from ..nn.core import MLP, dropout, kaiming_reinit


@dataclass(frozen=True)
class DeepGCNConfig:
    in_channels: int
    n_classes: int
    n_filters: int = 64
    n_blocks: int = 14
    conv: str = "mr"
    act: str = "relu"
    norm: str = "batch"
    bias: bool = True
    heads: int = 1
    block: str = "res"           # res | dense | plain
    dropout: float = 0.2
    k: int = 9                   # kNN neighbours (the dynamic variants, slice 9)
    use_dilation: bool = True
    stochastic: bool = False
    epsilon: float = 0.2
    num_points: int = 1024
    emb_dims: int = 1024
    knn_method: str = "exact"
    compute_dtype: Optional[str] = None  # "bfloat16": bf16 edge path, f32 accumulation


def _fusion_dims(cfg: DeepGCNConfig) -> int:
    """Width of the concatenated scales: the head and n − 1 blocks, each ch
    wide (res/plain), or the dense blocks' growing concatenations."""
    ch, n = cfg.n_filters, cfg.n_blocks
    if cfg.block.lower() == "dense":
        return int((ch + ch + ch * (n - 1)) * n // 2)
    return int(ch * n)


@torch.no_grad()
def _reinit_conv_weights(module: nn.Module, generator: Optional[torch.Generator]):
    """The JAX rule re-draws every 2-D leaf named `w`, the PyG convs' weights
    too ([in, out]: std √(2/in)), and zeroes every `b`."""
    for m in module.modules():
        if isinstance(m, (GCNConv, RSAGEConv)):
            w = m.weight
        elif isinstance(m, GATConv):
            w = m.gconv.weight
            m = m.gconv
        else:
            continue
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                * math.sqrt(2.0 / w.shape[0]))
        if m.bias is not None:
            m.bias.zero_()


class DeepGCNStatic(nn.Module):
    """The PPI DeepGCN; ``forward(x, g, generator)`` gives [N_pad,
    n_classes] logits, with dropout masks drawn from ``generator`` in
    training mode."""

    def __init__(self, cfg: DeepGCNConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        ch = c.n_filters
        common = dict(act=c.act, norm=c.norm, bias=c.bias, heads=c.heads,
                      compute_dtype=c.compute_dtype, generator=generator)
        self.head = GraphConv(c.in_channels, ch, c.conv, **common)
        if c.block.lower() == "dense":
            blocks = [DenseGraphBlock(ch + i * ch, ch, c.conv, **common)
                      for i in range(c.n_blocks - 1)]
        else:
            res_scale = 1.0 if c.block.lower() == "res" else 0.0
            blocks = [ResGraphBlock(ch, c.conv, res_scale=res_scale, **common)
                      for _ in range(c.n_blocks - 1)]
        self.backbone = nn.ModuleList(blocks)
        fd = _fusion_dims(c)
        self.fusion_block = MLP([fd, 1024], norm=None, bias=c.bias, act=c.act,
                                generator=generator)
        # the reference's Sequential holds Dropout at 1 and 3; the dropout here
        # draws from an explicit generator, so those slots hold no module
        self.prediction = nn.ModuleList([
            MLP([1 + fd, 512], norm=c.norm, bias=c.bias, act=c.act, generator=generator),
            nn.Identity(),
            MLP([512, 256], norm=c.norm, bias=c.bias, act=c.act, generator=generator),
            nn.Identity(),
            MLP([256, c.n_classes], norm=None, bias=c.bias, act=None, generator=generator)])
        kaiming_reinit(self, generator)
        _reinit_conv_weights(self, generator)

    def forward(self, x: torch.Tensor, g: Graph,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        feats = [self.head(x, g)]
        for blk in self.backbone:
            # a dense block returns [input ‖ new], and that whole
            # concatenation is both the next input and a fused scale
            feats.append(blk(feats[-1], g))
        cat = torch.cat(feats, 1)
        fus = self.fusion_block(cat, g.node_mask)
        h = torch.cat([cat, fus.amax(1, keepdim=True)], 1)
        for i in (0, 2, 4):
            h = self.prediction[i](h, g.node_mask)
            if i < 4:
                h = dropout(h, c.dropout, train=self.training, generator=generator)
        return h


def _needs_knn(name: str):
    raise NotImplementedError(f"{name} builds dilated kNN graphs on point clouds "
                              "(`ops/knn.py`): it comes with slice 9, the point-cloud slice")


class SparseDeepGCN(nn.Module):
    """The sparse semantic-segmentation DeepGCN: slice 9."""

    def __init__(self, *args, **kwargs):
        _needs_knn("SparseDeepGCN")


class DenseDeepGCN(nn.Module):
    """The dense point-cloud DeepGCN: slice 9."""

    def __init__(self, *args, **kwargs):
        _needs_knn("DenseDeepGCN")


class DeepGCNCls(nn.Module):
    """The ModelNet40 classifier: slice 9."""

    def __init__(self, *args, **kwargs):
        _needs_knn("DeepGCNCls")
