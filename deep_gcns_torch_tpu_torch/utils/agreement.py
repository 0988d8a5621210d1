"""One model on two devices, layer by layer: the card-vs-CPU comparisons of
the zoo (`DeepGCNStatic`) and of the point-cloud models (`DenseDeepGCN`,
`DeepGCNCls`, `SparseDeepGCN`) that `chip_smoke.py` and the card tests
share, and the kNN checks that the CPU tests use too.

Whole-model gradients are not compared: relu and the maxima are kinks, and
the devices' rounding differences move some pre-activation across one. A
graph layer (the head conv or a block) run on the same input on both sides
picks the same branches, except at EdgeConv's near-tied maxima: its
messages come out of an edge MLP whose rounding differs between the
devices, so there the two may route the gradient to another edge. Those
(receiver, channel) pairs get no cotangent (`edge_max_near_ties`, and
`max_over_k_near_ties` for the dense EdgeConv2d).

A point-cloud layer builds its kNN graph from its input, and the card's
float32 distances may order two near-equal neighbours differently from the
CPU's. So each layer gets the graph the CPU computes (`point_layer_results`),
the whole model's logits are compared on the CPU's graphs replayed on the
card (`KnnReplay`), and where the card's own lists differ the flips are
named (`knn_flips`), each with the float64 gap between the two neighbours'
distances; the tolerances stay as they are. `knn_rank_margin` gives the
smallest gap between consecutive neighbour ranks, which the CPU tests assert
is far above float error, so their points are free of ties.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..nn.core import _frozen_running_stats

LayerResult = Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


def graph_layers(model) -> List[Tuple[str, torch.nn.Module]]:
    """(name, module) of a DeepGCN's graph layers (`DeepGCNStatic` or a
    point-cloud model): the head conv and each block. The fusion and
    prediction layers hold no graph op."""
    return [("head", model.head)] + [(f"backbone.{i}", b) for i, b in enumerate(model.backbone)]


def edge_max_near_ties(conv, x: torch.Tensor, g, rel: float = 1e-4) -> torch.Tensor:
    """[N, C] bool: the (receiver, channel) pairs of `EdgeConv` ``conv`` on
    ``x`` whose max message is tied or within ``rel`` (of the largest
    message) of its runner-up."""
    n = x.shape[0]
    with torch.no_grad():
        r = torch.clamp(g.receivers.long(), max=n - 1)
        x_i = x.index_select(0, r)
        x_j = x.index_select(0, torch.clamp(g.senders.long(), max=n - 1))
        msg = conv.nn(torch.cat([x_i, x_j - x_i], 1), g.edge_mask)
        ninf = torch.tensor(float("-inf"), device=msg.device)
        m = torch.where(g.edge_mask[:, None], msg, ninf)
        ids = r[:, None].expand_as(m)
        top = torch.full((n, m.shape[1]), float("-inf"), device=m.device).scatter_reduce(
            0, ids, m, "amax")
        is_top = (m == top.index_select(0, r)) & g.edge_mask[:, None]
        n_top = torch.zeros(top.shape, device=m.device).index_add_(0, r, is_top.float())
        second = torch.full(top.shape, float("-inf"), device=m.device).scatter_reduce(
            0, ids, torch.where(is_top, ninf, m), "amax")
        return (n_top > 1) | (top - second < rel * float(msg.abs().max()))


def layer_results(models, graphs, conv: str, block: str, gen: torch.Generator
                  ) -> Iterator[Tuple[str, List[LayerResult]]]:
    """For ``models`` (the same `DeepGCNStatic` weights on the card and on
    the CPU) and ``graphs`` (the same graph there), run each graph layer on
    the CPU model's input to it under a random cotangent from ``gen`` (0 on
    padding nodes and at EdgeConv's near ties). Yields (layer name, [card,
    cpu]), each (output, the input's gradient, every parameter's gradient)
    on the CPU."""
    gd, gc = graphs
    h = gc.x
    for (lname, l_dev), (_, l_cpu) in zip(graph_layers(models[0]), graph_layers(models[1])):
        outs: List[LayerResult] = []
        co = None
        for layer, g in ((l_dev, gd), (l_cpu, gc)):
            x = h.to(g.senders.device).clone().requires_grad_(True)
            out = layer(x, g)
            if co is None:
                co = torch.randn(out.shape, generator=gen)
                co[gc.n_node:] = 0.0
                if conv == "edge":
                    body = l_cpu.gconv if lname == "head" else l_cpu.body.gconv
                    ties = edge_max_near_ties(body, h, gc)
                    # a dense block's output is [input ‖ conv's output]
                    at = h.shape[1] if block == "dense" and lname != "head" else 0
                    co[:, at:at + ties.shape[1]][ties] = 0.0
            (out * co.to(out.device)).sum().backward()
            outs.append((out.detach().cpu(), x.grad.cpu(),
                         {k: p.grad.cpu() for k, p in layer.named_parameters()}))
        yield lname, outs
        h = outs[1][0]


# ---------------------------------------------------------------------------
# kNN ties and flips
# ---------------------------------------------------------------------------

def _dist64(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().double().cpu()
    return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)


def knn_rank_margin(x: torch.Tensor, k: int) -> float:
    """The smallest relative gap, over every row of x [B, N, C], between
    consecutive ranks of the k + 1 nearest (float64 distances, self
    excluded): above float32 error, every kNN of up to k neighbours, dilated
    rank for rank, is unique."""
    d = torch.sort(_dist64(x), -1).values[..., 1:k + 2]
    scale = float(d.max())
    return float((d[..., 1:] - d[..., :-1]).min()) / scale


def knn_flips(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor,
              limit: int = 10) -> List[dict]:
    """The rows where two neighbour lists [B, N, k] of x [B, N, C] differ:
    for each (at most ``limit``), the batch, point, first differing rank,
    both ids and the float64 relative gap between their distances (a near
    tie when it is within float32 error)."""
    got, want = got.detach().cpu().long(), want.detach().cpu().long()
    rows = torch.nonzero((got != want).any(-1))
    if not len(rows):
        return []
    d = _dist64(x)
    scale = float(d.max())
    out = []
    for b, i in rows[:limit].tolist():
        r = int(torch.nonzero(got[b, i] != want[b, i])[0])
        g, w = int(got[b, i, r]), int(want[b, i, r])
        out.append(dict(batch=b, point=i, rank=r, got=g, want=w,
                        rel_gap=abs(float(d[b, i, g] - d[b, i, w])) / scale))
    return out


def max_over_k_near_ties(y: torch.Tensor, rel: float = 1e-4) -> torch.Tensor:
    """[B, N, C] bool: where the max over axis 2 of y [B, N, K, C] is tied
    or within ``rel`` (of max|y|) of its runner-up."""
    top2 = torch.topk(y.detach(), 2, dim=2).values
    return (top2[:, :, 0] - top2[:, :, 1]) <= rel * float(y.abs().max())


class KnnReplay(contextlib.AbstractContextManager):
    """Within ``with KnnReplay() as rec``, every kNN the point-cloud models
    build (`dilated_knn_graph_dense` and `dilated_knn_graph_flat` as
    `convs.dense`, `convs.sparse` and `models.deepgcn` call them) is
    recorded in ``rec.graphs``; within ``KnnReplay(rec.graphs)`` each call
    returns the recorded graph (moved to its input's device) instead, and
    ``flips`` holds, per call, `knn_flips` of the graph the device itself
    computes against the replayed one."""

    def __init__(self, replay: Optional[List[tuple]] = None):
        self.replay, self.graphs, self.flips = replay, [], []

    def _wrap(self, fn, flat: bool):
        def call(x, *a, **kw):
            own = fn(x, *a, **kw)
            if self.replay is None:
                self.graphs.append((x.detach().cpu(), tuple(t.cpu() for t in own)))
                return own
            xr, graph = self.replay[len(self.graphs)]
            self.graphs.append((xr, graph))
            if flat:  # per-graph lists of the recorded input
                n = kw["num_nodes_per_graph"]
                b = x.shape[0] // n
                got = own[0].cpu().long().reshape(b, n, -1) % n
                want = graph[0].long().reshape(b, n, -1) % n
                self.flips.append(knn_flips(xr.reshape(b, n, -1), got, want))
            else:
                self.flips.append(knn_flips(xr, own[0], graph[0]))
            return tuple(t.to(x.device) for t in graph)
        return call

    def __enter__(self):
        from ..convs import dense, sparse
        from ..models import deepgcn
        self._saved = []
        for mod in (dense, sparse, deepgcn):
            for name, flat in (("dilated_knn_graph_dense", False),
                               ("dilated_knn_graph_flat", True)):
                if hasattr(mod, name):
                    fn = getattr(mod, name)
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._wrap(fn, flat))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _dense_ties(layer, x: torch.Tensor, nn_idx: torch.Tensor, rel: float) -> torch.Tensor:
    """`max_over_k_near_ties` of a dense EdgeConv2d layer's messages."""
    from ..ops.gather import gather_neighbors
    conv = layer.gconv if hasattr(layer, "gconv") else layer.body.gconv
    with torch.no_grad(), _frozen_running_stats():
        xe = x if conv.compute_dtype is None else x.to(conv.compute_dtype)
        x_j = gather_neighbors(xe, nn_idx)
        x_i = xe[:, :, None, :].expand_as(x_j)
        return max_over_k_near_ties(conv.nn(torch.cat([x_i, x_j - x_i], -1)), rel)


def point_layer_results(models, x: torch.Tensor, gen: torch.Generator, sparse: bool = False,
                        rel: float = 1e-4) -> Iterator[Tuple[str, List[LayerResult], list]]:
    """For ``models`` (the same point-cloud model on the card and on the CPU)
    and the CPU input x ([B, N, C] dense, [B·n, C] with ``sparse``), run each
    graph layer on the CPU model's input to it, on the graph the CPU builds
    from that input (xyz for the head, the block's k and dilation after it),
    under a random cotangent from ``gen`` that is 0 at the EdgeConv maxima's
    near ties. Yields (layer name, [card, cpu], the flips of the card's own
    kNN of that input against the CPU's); each result is (output, the
    input's gradient, every parameter's gradient) on the CPU."""
    from ..convs.sparse import knn_graph
    from ..ops.knn import dilated_knn_graph_dense, dilated_knn_graph_flat

    cfg = models[1].cfg
    dev = next(models[0].parameters()).device
    h = x
    for (lname, l_dev), (_, l_cpu) in zip(graph_layers(models[0]), graph_layers(models[1])):
        head = lname == "head"
        k = cfg.k
        d = 1 if head else l_cpu.body.dilation
        src = h[..., 0:3] if head else h
        if sparse:
            graphs = [knn_graph(*dilated_knn_graph_flat(s, k, d, num_nodes_per_graph=cfg.num_points),
                                s.shape[0]) for s in (src, src.to(dev))]
            n = cfg.num_points
            own = [gr.senders.cpu().long().reshape(-1, n, k) % n for gr in graphs]
            flips = knn_flips(src.reshape(-1, n, src.shape[-1]), own[1], own[0])
            args = [graphs[0].to(dev), graphs[0]]
        else:
            own = [dilated_knn_graph_dense(s, k, d)[0].cpu() for s in (src, src.to(dev))]
            flips = knn_flips(src, own[1], own[0])
            args = [(own[0].to(dev), None), (own[0], None)]
        outs: List[LayerResult] = []
        co = None
        for layer, arg in ((l_dev, args[0]), (l_cpu, args[1])):
            xi = h.to(dev if layer is l_dev else "cpu").clone().requires_grad_(True)
            out = layer(xi, arg) if head else layer(xi, arg, None)
            if co is None:
                co = torch.randn(out.shape, generator=gen)
                if cfg.conv == "edge":
                    if sparse:
                        with _frozen_running_stats():
                            ties = edge_max_near_ties(
                                l_cpu.gconv if head else l_cpu.body.gconv, h, args[1], rel)
                    else:
                        ties = _dense_ties(l_cpu, h, args[1][0], rel)
                    at = h.shape[-1] if cfg.block.lower() == "dense" and not head else 0
                    co[..., at:at + ties.shape[-1]][ties] = 0.0
            (out * co.to(out.device)).sum().backward()
            outs.append((out.detach().cpu(), xi.grad.cpu(),
                         {kk: p.grad.cpu() for kk, p in layer.named_parameters()}))
        yield lname, outs, flips
        h = outs[1][0]
