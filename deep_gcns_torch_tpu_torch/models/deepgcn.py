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

The point-cloud models build dilated kNN graphs per forward (`ops/knn.py`,
JAX `models/deepgcn.py:157-450`):

* `SparseDeepGCN` (`examples/sem_seg_sparse/architecture.py:9-70`): flat
  [B·n, C] points, the head's kNN on xyz, `DynConv` blocks at dilation
  1 + i, fusion MLP to 1024, the per-cloud max broadcast back, three
  prediction MLPs (dropout after the second), kaiming init as above;
* `DenseDeepGCN` (`examples/sem_seg_dense/architecture.py:7-56`):
  channels-last [B, N, C], the head's kNN on xyz, `DynConv2d` blocks at
  dilation 1 + i, fusion `BasicConv` to 1024, its max over the points
  broadcast back, `BasicConv`s to 512, 256 and the classes with dropout
  after the 256;
* `DeepGCNCls` (`examples/modelnet_cls/architecture.py:11-81`): the same
  backbone (dilation 1 + i with ``use_dilation``), fusion `BasicConv` to
  ``emb_dims`` (LeakyReLU, no bias), global max and mean pool, and a
  LeakyReLU head with dropout.

The dense models' `BasicConv` weights are kaiming-normal at construction,
as the JAX package draws them (no re-draw). Every forward takes the
generator of its dropout masks and of stochastic dilation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..convs import dense as cd
from ..convs.sparse import (DenseDynBlock, DenseGraphBlock, GATConv, GCNConv, GraphConv,
                            PlainDynBlock, ResDynBlock, ResGraphBlock, RSAGEConv, knn_graph)
from ..graph import Graph
from ..nn.core import MLP, dropout, kaiming_reinit
from ..ops.knn import dilated_knn_graph_dense, dilated_knn_graph_flat


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


class SparseDeepGCN(nn.Module):
    """The sparse S3DIS DeepGCN; ``forward(x, g, generator)`` takes x =
    cat(xyz, colour, …) [B·n, C] (n = ``num_points``) and the head's graph
    (None: the kNN on xyz is built here) and gives [B·n, n_classes]."""

    def __init__(self, cfg: DeepGCNConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        ch = c.n_filters
        dyn = dict(act=c.act, norm=c.norm, bias=c.bias, num_points=c.num_points,
                   knn_method=c.knn_method, compute_dtype=c.compute_dtype, generator=generator)
        self.head = GraphConv(c.in_channels, ch, c.conv, c.act, c.norm, c.bias,
                              compute_dtype=c.compute_dtype, generator=generator)
        kind = c.block.lower()
        blocks = []
        for i in range(c.n_blocks - 1):
            if kind == "dense":
                blocks.append(DenseDynBlock(ch + ch * i, ch, c.k, 1 + i, c.conv,
                                            stochastic=c.stochastic, epsilon=c.epsilon, **dyn))
            elif kind == "res":
                blocks.append(ResDynBlock(ch, c.k, 1 + i, c.conv, stochastic=c.stochastic,
                                          epsilon=c.epsilon, **dyn))
            else:
                blocks.append(PlainDynBlock(ch, c.k, 1, c.conv, **dyn))
        self.backbone = nn.ModuleList(blocks)
        fd = _fusion_dims(c)
        self.fusion_block = MLP([fd, 1024], norm=c.norm, bias=c.bias, act=c.act,
                                generator=generator)
        self.prediction = nn.ModuleList([
            MLP([fd + 1024, 512], norm=c.norm, bias=c.bias, act=c.act, generator=generator),
            MLP([512, 256], norm=c.norm, bias=c.bias, act=c.act, generator=generator),
            MLP([256, c.n_classes], norm=None, bias=c.bias, act=None, generator=generator)])
        kaiming_reinit(self, generator)
        _reinit_conv_weights(self, generator)

    def forward(self, x: torch.Tensor, g: Optional[Graph] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        n = x.shape[0]
        if g is None:
            senders, receivers = dilated_knn_graph_flat(
                x[:, 0:3], c.k, 1, num_nodes_per_graph=c.num_points, method=c.knn_method)
            g = knn_graph(senders, receivers, n)
        feats = [self.head(x, g)]
        for blk in self.backbone:
            feats.append(blk(feats[-1], None, generator))
        cat = torch.cat(feats, 1)
        fus = self.fusion_block(cat, g.node_mask)
        # the per-cloud max broadcast back (`sem_seg_sparse/architecture.py:68-69`)
        nb = n // c.num_points
        gmax = torch.amax(fus.reshape(nb, c.num_points, -1), 1, keepdim=True)
        fus = gmax.expand(nb, c.num_points, gmax.shape[-1]).reshape(n, -1)
        h = torch.cat([fus, cat], 1)
        for i, m in enumerate(self.prediction):
            h = m(h, g.node_mask)
            if i == 1:
                h = dropout(h, c.dropout, train=self.training, generator=generator)
        return h


def _dense_blocks(c: DeepGCNConfig, dilated: bool, generator) -> nn.ModuleList:
    """The dense backbone: n_blocks − 1 res (dilation 1 + i when ``dilated``),
    dense (dilation 1 + i, growing by n_filters) or plain (dilation 1)
    `DynConv2d` blocks."""
    ch, kind = c.n_filters, c.block.lower()
    common = dict(conv=c.conv, act=c.act, norm=c.norm, bias=c.bias, knn_method=c.knn_method,
                  compute_dtype=c.compute_dtype, generator=generator)
    blocks = []
    for i in range(c.n_blocks - 1):
        if kind == "dense":
            blocks.append(cd.DenseDynBlock2d(ch + ch * i, ch, c.k, 1 + i,
                                             stochastic=c.stochastic, epsilon=c.epsilon,
                                             **common))
        elif kind == "res":
            blocks.append(cd.ResDynBlock2d(ch, c.k, 1 + i if dilated else 1,
                                           stochastic=c.stochastic, epsilon=c.epsilon,
                                           **common))
        else:
            blocks.append(cd.PlainDynBlock2d(ch, c.k, 1, **common))
    return nn.ModuleList(blocks)


def _point_knn(c: DeepGCNConfig, x: torch.Tensor, train: bool, generator):
    """The head's kNN on xyz (no centres passed: they are canonical)."""
    nn_idx, _ = dilated_knn_graph_dense(x[..., 0:3], c.k, 1, stochastic=c.stochastic,
                                        epsilon=c.epsilon, train=train, generator=generator,
                                        method=c.knn_method)
    return nn_idx, None


class DenseDeepGCN(nn.Module):
    """The dense S3DIS / PartNet DeepGCN; ``forward(x, edge_index,
    generator)`` takes x [B, N, C] (kNN on x[..., :3] when ``edge_index`` is
    None) and gives [B, N, n_classes]."""

    def __init__(self, cfg: DeepGCNConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        ch = c.n_filters
        self.head = cd.GraphConv2d(c.in_channels, ch, c.conv, c.act, c.norm, c.bias,
                                   c.compute_dtype, generator)
        self.backbone = _dense_blocks(c, True, generator)
        fd = _fusion_dims(c)
        self.fusion_block = cd.BasicConv([fd, 1024], c.act, c.norm, c.bias, generator=generator)
        # the reference's Sequential holds its Dropout at 2; the dropout here
        # draws from an explicit generator, so that slot holds no module
        self.prediction = nn.ModuleList([
            cd.BasicConv([fd + 1024, 512], c.act, c.norm, c.bias, generator=generator),
            cd.BasicConv([512, 256], c.act, c.norm, c.bias, generator=generator),
            nn.Identity(),
            cd.BasicConv([256, c.n_classes], None, None, c.bias, generator=generator)])

    def forward(self, x: torch.Tensor, edge_index=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.cfg
        if edge_index is None:
            edge_index = _point_knn(c, x, self.training, generator)
        feats = [self.head(x, edge_index, generator)]
        for blk in self.backbone:
            feats.append(blk(feats[-1], None, generator))
        fus4 = torch.cat(feats, -1)[:, :, None, :]  # [B, N, 1, C]
        fus = self.fusion_block(fus4, generator)
        # the max over the points broadcast back (`sem_seg_dense/architecture.py:54-55`)
        gmax = torch.amax(fus, 1, keepdim=True)
        h = torch.cat([gmax.expand(fus.shape), fus4], -1)
        for i in (0, 1, 3):
            h = self.prediction[i](h, generator)
            if i == 1:
                h = dropout(h, c.dropout, train=self.training, generator=generator)
        return h[:, :, 0, :]


class DeepGCNCls(nn.Module):
    """The ModelNet40 classifier; ``forward(x, generator)`` takes x [B, N,
    3] and gives [B, n_classes] logits."""

    def __init__(self, cfg: DeepGCNConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        ch = c.n_filters
        self.head = cd.GraphConv2d(c.in_channels, ch, c.conv, c.act, c.norm, False,
                                   c.compute_dtype, generator)
        self.backbone = _dense_blocks(c, c.use_dilation, generator)
        fd = _fusion_dims(c)
        self.fusion_block = cd.BasicConv([fd, c.emb_dims], "leakyrelu", c.norm, False,
                                         generator=generator)
        self.prediction = nn.ModuleList([
            cd.BasicConv([c.emb_dims * 2, 512], "leakyrelu", c.norm, drop=c.dropout,
                         generator=generator),
            cd.BasicConv([512, 256], "leakyrelu", c.norm, drop=c.dropout, generator=generator),
            cd.BasicConv([256, c.n_classes], None, None, generator=generator)])

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.cfg
        edge_index = _point_knn(c, x, self.training, generator)
        feats = [self.head(x, edge_index, generator)]
        for blk in self.backbone:
            feats.append(blk(feats[-1], None, generator))
        fus = self.fusion_block(torch.cat(feats, -1)[:, :, None, :], generator)
        # adaptive max and mean pools (`modelnet_cls/architecture.py:79-80`)
        h = torch.cat([torch.amax(fus, (1, 2)), fus.mean((1, 2))], -1)[:, None, None, :]
        for m in self.prediction:
            h = m(h, generator)
        return h[:, 0, 0, :]
