"""Grouped additive reversible coupling (counterpart of
`deep_gcns_torch_tpu/rev/coupling.py:25-144`, reference
`eff_gcn_modules/rev/memgcn.py:9-52`).

x splits into G channel chunks; y_i = x_i + F_i(u_i) with u_0 = Σ_{j≥1} x_j
and u_i = y_{i−1}. The additive structure gives an exact inverse, so the
backward rebuilds a layer's input instead of storing it (`rev/invertible.py`).
Extra per-node and per-edge arguments (the shared dropout mask, the edge
embeddings in both edge orders) are chunked alongside, as the reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..graph import Graph
from ..utils.profiling import span


def _chunk(x: Optional[torch.Tensor], group: int) -> List[Optional[torch.Tensor]]:
    if x is None:
        return [None] * group
    if x.shape[-1] % group:
        raise ValueError(f"{x.shape[-1]} channels do not split into {group} groups")
    return list(torch.chunk(x, group, dim=-1))


def _arg_chunks(args: Sequence[Optional[torch.Tensor]], group: int) -> List[tuple]:
    """Per group, the tuple of that group's chunk of every argument."""
    return list(zip(*[_chunk(a, group) for a in args])) or [()] * group


class GroupAdditiveCoupling(nn.Module):
    """The coupling of the group functions ``fms`` (one per group, each on
    C/G channels, each with its own parameters), held as `Fms` as in the
    reference. A group function is called ``fm(u, g, chunk_args=...)`` and must
    keep no state: BatchNorm's running statistics would break the exact
    inverse, so a group function with persistent buffers is refused."""

    def __init__(self, fms: Sequence[nn.Module]):
        super().__init__()
        self.Fms = nn.ModuleList(fms)
        self.group = len(self.Fms)
        for fm in self.Fms:
            params = {name for name, _ in fm.named_parameters()}
            state = sorted(k for k in fm.state_dict() if k not in params)
            if state:
                raise ValueError("GroupAdditiveCoupling needs group functions that keep no "
                                 f"state (use norm='layer'); this one keeps {state}")

    def forward(self, x: torch.Tensor, g: Graph, *args) -> torch.Tensor:
        xs = _chunk(x, self.group)
        ac = _arg_chunks(args, self.group)
        # the reference: y_0's input is Σ x_{1..} (0 for one group)
        y_in = sum(xs[1:]) if self.group > 1 else torch.zeros_like(xs[0])
        ys = []
        for i, fm in enumerate(self.Fms):
            y_in = xs[i] + fm(y_in, g, chunk_args=ac[i])
            ys.append(y_in)
        return torch.cat(ys, -1)

    def inverse(self, y: torch.Tensor, g: Graph, *args) -> torch.Tensor:
        ys = _chunk(y, self.group)
        ac = _arg_chunks(args, self.group)
        xs: List[Optional[torch.Tensor]] = [None] * self.group
        for i in range(self.group - 1, -1, -1):
            if i > 0:
                u = ys[i - 1]
            else:
                u = sum(xs[1:]) if self.group > 1 else torch.zeros_like(ys[0])
            xs[i] = ys[i] - self.Fms[i](u, g, chunk_args=ac[i])
        return torch.cat(xs, -1)

    def inverse_and_vjp(self, y: torch.Tensor, g: Graph, gy: torch.Tensor, *args,
                        arg_grads: Optional[Sequence[bool]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                                   List[Optional[torch.Tensor]]]:
        """The inverse fused with the VJP (`coupling.py:85-144`): each group
        function is evaluated ONCE, with grad, at u_i; its primal rebuilds
        x_i = y_i − F_i(u_i) and `torch.autograd.grad` of the same primal
        gives the cotangents of u_i, of the group's parameters and of its
        argument chunks. The cotangents chain by hand:

            gx_i = gy_i;  gu_i adds to gy_{i−1} (i > 0), or to every gx_{j≥1}.

        ``arg_grads`` says which arguments want a cotangent (default: those
        that require grad). Returns (x, gx, the parameter gradients in the
        order of ``[p for p in self.parameters() if p.requires_grad]``, and
        one cotangent per argument: None where no group function's output
        depends on it, as for the receiver-ordered edge embeddings, which the
        fused aggregation reads detached)."""
        G = self.group
        if arg_grads is None:
            arg_grads = [a is not None and a.requires_grad for a in args]
        ys = _chunk(y, G)
        gys = _chunk(gy, G)
        chunks = [_chunk(None if a is None else a.detach(), G) for a in args]
        xs: List[Optional[torch.Tensor]] = [None] * G
        gxs: List[Optional[torch.Tensor]] = [None] * G
        gps: List[List[torch.Tensor]] = [[] for _ in range(G)]
        gargs = [[None] * G for _ in args]
        for i in range(G - 1, -1, -1):
            if i > 0:
                u = ys[i - 1]
            else:
                u = sum(xs[1:]) if G > 1 else torch.zeros_like(ys[0])
            u = u.detach().requires_grad_(True)
            a_i = tuple(None if c[i] is None else
                        c[i].detach().requires_grad_(bool(need))
                        for c, need in zip(chunks, arg_grads))
            params = [p for p in self.Fms[i].parameters() if p.requires_grad]
            with torch.enable_grad(), span("rev.recompute"):
                prim = self.Fms[i](u, g, chunk_args=a_i)
            xs[i] = ys[i] - prim.detach()
            want = [k for k, a in enumerate(a_i) if a is not None and a.requires_grad]
            with span("rev.vjp"):
                grads = torch.autograd.grad(prim, [u] + params + [a_i[k] for k in want],
                                            gys[i], allow_unused=True)
            gu = grads[0] if grads[0] is not None else torch.zeros_like(u)
            gps[i] = [torch.zeros_like(p) if d is None else d
                      for p, d in zip(params, grads[1:1 + len(params)])]
            for k, d in zip(want, grads[1 + len(params):]):
                gargs[k][i] = d
            gxs[i] = gys[i]
            if i > 0:
                gys[i - 1] = gys[i - 1] + gu
            else:
                for j in range(1, G):
                    gxs[j] = gxs[j] + gu
        ga = [None if all(d is None for d in parts) else
              torch.cat([torch.zeros_like(c[i]) if d is None else d
                         for i, d in enumerate(parts)], -1)
              for parts, c in zip(gargs, chunks)]
        return (torch.cat(xs, -1), torch.cat(gxs, -1), [d for gp in gps for d in gp], ga)
