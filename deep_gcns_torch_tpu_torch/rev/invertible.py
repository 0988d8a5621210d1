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

``g`` is handed to the couplings as it is: a `Graph`, or one rank's
`parallel.spatial.RankShard`, whose group functions exchange rows across
ranks; the backward then re-issues their collectives layer by layer in the
same order on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .coupling import GroupAdditiveCoupling


class _ReversibleStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layers, layer_args, g, n_args, x, *rest):
        args = rest[:n_args]
        with torch.no_grad():
            h = x
            for layer, own in zip(layers, layer_args):
                h = layer(h, g, *args, *own)
        ctx.layers, ctx.layer_args, ctx.g, ctx.n_args = layers, layer_args, g, n_args
        ctx.save_for_backward(h, *args)
        return h

    @staticmethod
    def backward(ctx, gy):
        y, *args = ctx.saved_tensors
        need = ctx.needs_input_grad[5:5 + ctx.n_args]
        g_args = [None] * ctx.n_args
        g_params = []
        for layer, own in zip(reversed(ctx.layers), reversed(ctx.layer_args)):
            y, gy, gp, ga = layer.inverse_and_vjp(y, ctx.g, gy, *args, *own,
                                                  arg_grads=tuple(need) + (False,) * len(own))
            g_params.append(gp)
            for k, d in enumerate(ga[:ctx.n_args]):
                if d is not None:  # ga's tensors are fresh: accumulate in place
                    g_args[k] = d if g_args[k] is None else g_args[k].add_(d)
        flat = [d for gp in reversed(g_params) for d in gp]
        return (None, None, None, None, gy, *g_args, *flat)


def reversible_stack(layers: Sequence[GroupAdditiveCoupling], x: torch.Tensor, g,
                     args: Sequence[Optional[torch.Tensor]] = (),
                     layer_args: Optional[Sequence[Sequence[torch.Tensor]]] = None
                     ) -> torch.Tensor:
    """x through the couplings ``layers`` in order, each called as
    ``layer(h, g, *args, *layer_args[l])``, with activation memory that does
    not grow with the depth. ``args`` are shared by every layer; their
    gradients are the sums over the layers. ``layer_args`` (one sequence per
    layer, the same length for all) are per-layer arguments without
    gradients, such as RevGAT's edge-drop keys; the couplings chunk them
    across groups as they chunk the shared ones."""
    if layer_args is None:
        layer_args = [()] * len(layers)
    if len(layer_args) != len(layers):
        raise ValueError(f"{len(layer_args)} layer_args for {len(layers)} layers")
    params = [p for layer in layers for p in layer.parameters() if p.requires_grad]
    return _ReversibleStack.apply(layers, layer_args, g, len(args), x, *args, *params)
