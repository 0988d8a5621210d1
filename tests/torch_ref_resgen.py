"""Plain float32 reference of ResGEN-28, DeeperGCN's ogbn-arxiv model
(lightaime/deep_gcns_torch, `examples/ogb/ogbn_arxiv/model.py` and
`gcn_lib/sparse/torch_vertex.py` GENConv): forward, loss and gradients with
plain torch operations and autograd. Imports nothing of this repository.

    h = enc(x);  h = conv_0(h)
    h = h + conv_l(drop(relu(norm_{l-1}(h))))      l = 1 .. L-1   (res+)
    logits = pred(drop(relu(norm_{L-1}(h))))
    conv(h) = mlp(h + agg(h))
    agg(h)[r] = sum over edges (s -> r) of softmax_e(t * m_e) * m_e,
    m_e = relu(h[s]) + eps

The softmax is PyG's `scatter_softmax`, written out: each receiver's scores
shifted by that receiver's own maximum, per channel, and with softmax_sg its
weights are detached (stop-gradient), so only the messages carry gradient.
The norm is batch norm on the batch's moments (two passes, biased variance);
the MLP is one Linear. Parameters come in a dict under the port's
`state_dict` names (`node_features_encoder`, `gcns.{l}.mlp.0`, `norms.{l}`,
`node_pred_linear`).

Departures from the published description: dropout takes the masks it is
handed (none: rate 0), and evaluation mode (running statistics) is left to
the benchmark's copy, `h100bench/reference/resgen28-arxiv.py`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

EPS_MSG = 1e-7
EPS_NORM = 1e-5


def softmax_sg_agg(h: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                   t: float, learn_t: bool = False) -> torch.Tensor:
    """agg(h) [n, C] over the edges (senders -> receivers), int64."""
    n, c = h.shape
    m = torch.relu(h[senders]) + EPS_MSG
    s = t * m
    idx = receivers[:, None].expand(-1, c)
    top = torch.full((n, c), float("-inf"), dtype=h.dtype, device=h.device)
    top = top.scatter_reduce(0, idx, s.detach(), "amax")
    w = torch.exp(s - top[receivers])
    den = torch.zeros((n, c), dtype=h.dtype, device=h.device).index_add(0, receivers, w)
    a = w / den[receivers]
    if not learn_t:
        a = a.detach()
    return torch.zeros((n, c), dtype=h.dtype, device=h.device).index_add(0, receivers, a * m)


def batch_norm(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = h.mean(0)
    var = ((h - mu) ** 2).mean(0)
    return (h - mu) / torch.sqrt(var + EPS_NORM) * w + b


def linear(h: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return h @ p[name + ".weight"].t() + p[name + ".bias"]


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, senders: torch.Tensor,
            receivers: torch.Tensor, num_layers: int, t: float = 0.1,
            masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Logits [n, classes] in training mode; ``masks`` (optional) are the
    dropout multipliers of the L-1 prologues and the head, in that order."""
    def drop(h, k):
        return h if masks is None else h * masks[k]

    def conv(l, h):
        return linear(h + softmax_sg_agg(h, senders, receivers, t), p, f"gcns.{l}.mlp.0")

    h = conv(0, linear(x, p, "node_features_encoder"))
    for l in range(1, num_layers):
        a = torch.relu(batch_norm(h, p[f"norms.{l - 1}.weight"], p[f"norms.{l - 1}.bias"]))
        h = h + conv(l, drop(a, l - 1))
    last = num_layers - 1
    h = torch.relu(batch_norm(h, p[f"norms.{last}.weight"], p[f"norms.{last}.bias"]))
    return linear(drop(h, last), p, "node_pred_linear")


def loss_and_grads(p: Dict[str, torch.Tensor], x, senders, receivers, labels, rows,
                   num_layers: int, t: float = 0.1):
    """(logits, loss, {name: gradient}): the mean cross entropy over
    ``rows`` and the gradient of every parameter."""
    q = {k: v.detach().clone().float().requires_grad_(True) for k, v in p.items()}
    logits = forward(q, x, senders, receivers, num_layers, t)
    loss = F.cross_entropy(logits[rows], labels[rows])
    names = list(q)
    grads = torch.autograd.grad(loss, [q[k] for k in names])
    return logits.detach(), loss.detach(), dict(zip(names, grads))
