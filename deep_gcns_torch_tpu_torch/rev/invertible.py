"""The O(1)-activation-memory reversible stack (counterpart of
`deep_gcns_torch_tpu/rev/invertible.py:31-86`, reference
`eff_gcn_modules/rev/gcn_revop.py:15-157`).

One `torch.autograd.Function` over the L couplings:

* the forward runs them under `torch.no_grad()` and saves only the last
  output and the shared arguments, so no layer keeps an activation;
* the backward walks the layers in reverse. Each coupling's
  `inverse_and_vjp` evaluates every group function once, with grad, rebuilds
  the layer's input from that primal and takes the cotangents of the input,
  the parameters and the argument chunks from the same graph: one group
  evaluation per group per layer, never an inverse followed by a re-forward;
* the cotangents of the shared arguments (the edge embeddings) add up over
  the layers;
* the parameters enter the Function as one flat list, so that autograd
  routes their gradients.

The reference's RNG-state capture dissolves here too: the shared dropout mask
is an explicit argument, so the inverse sees the forward's mask by
construction.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..graph import Graph
from .coupling import GroupAdditiveCoupling


class _ReversibleStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layers, g, n_args, x, *rest):
        args = rest[:n_args]
        with torch.no_grad():
            h = x
            for layer in layers:
                h = layer(h, g, *args)
        ctx.layers, ctx.g, ctx.n_args = layers, g, n_args
        ctx.save_for_backward(h, *args)
        return h

    @staticmethod
    def backward(ctx, gy):
        y, *args = ctx.saved_tensors
        need = ctx.needs_input_grad[4:4 + ctx.n_args]
        g_args = [None] * ctx.n_args
        g_params = []
        for layer in reversed(ctx.layers):
            y, gy, gp, ga = layer.inverse_and_vjp(y, ctx.g, gy, *args, arg_grads=need)
            g_params.append(gp)
            for k, d in enumerate(ga):
                if d is not None:  # ga's tensors are fresh: accumulate in place
                    g_args[k] = d if g_args[k] is None else g_args[k].add_(d)
        flat = [d for gp in reversed(g_params) for d in gp]
        return (None, None, None, gy, *g_args, *flat)


def reversible_stack(layers: Sequence[GroupAdditiveCoupling], x: torch.Tensor, g: Graph,
                     args: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """x through the couplings ``layers`` in order, each called as
    ``layer(h, g, *args)``, with activation memory that does not grow with
    the depth. ``args`` are shared by every layer; their gradients are the
    sums over the layers."""
    params = [p for layer in layers for p in layer.parameters() if p.requires_grad]
    return _ReversibleStack.apply(layers, g, len(args), x, *args, *params)
