"""One `DeepGCNStatic` on two devices, layer by layer: the card-vs-CPU
comparison of the zoo that `chip_smoke.py` and the card tests share.

Whole-model gradients are not compared: relu and the maxima are kinks, and
the devices' rounding differences move some pre-activation across one. A
graph layer (the head conv or a block) run on the same input on both sides
picks the same branches, except at EdgeConv's near-tied maxima: its
messages come out of an edge MLP whose rounding differs between the
devices, so there the two may route the gradient to another edge. Those
(receiver, channel) pairs get no cotangent (`edge_max_near_ties`).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

LayerResult = Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


def graph_layers(model) -> List[Tuple[str, torch.nn.Module]]:
    """(name, module) of a `DeepGCNStatic`'s graph layers: the head conv and
    each block. The fusion and prediction MLPs hold no graph op."""
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
