"""Plain float32 reference of ResGEN-28, DeeperGCN's ogbn-arxiv model
(lightaime/deep_gcns_torch `examples/ogb/ogbn_arxiv`, `model.py` with
`gcn_lib/sparse/torch_vertex.py` GENConv):

    h = enc(x);  h = conv_0(h)
    h = h + conv_l(drop(relu(norm_{l-1}(h))))      l = 1 .. 27   (res+)
    logits = pred(drop(relu(norm_27(h))))
    conv(h) = mlp(h + agg(h)),   mlp one Linear
    agg(h)[r] = sum over edges (s -> r) of softmax_e(t * m_e) * m_e,
    m_e = relu(h[s]) + 1e-7,  t = 0.1

The softmax is PyG's `scatter_softmax`: each receiver's scores shifted by
that receiver's own maximum, per channel; softmax_sg detaches its weights,
so the backward carries the cotangent through the messages alone. Written
out over blocks of edges with its own backward, so that no [E, C] tensor is
kept for autograd and 28 layers of 2.78 M edges x 128 channels fit on the
card. Batch norm on the batch's moments in training (two passes, biased
variance; the running statistics take the unbiased one at momentum 0.1) and
on the running statistics in evaluation. Cross entropy over the training
nodes; Adam (betas 0.9, 0.999, eps 1e-8) at the configuration's rate.

Departures from the published description: the graph, labels and splits
are the benchmark's synthetic ones; dropout follows the seeded stream in the
program's order of draws (one [n_pad, 128] draw a prologue, then the
head's, kept at draws >= rate); the evaluation after the first step is the
only one read.

Imports nothing of this repository's packages."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import plain

EPS_MSG = 1e-7
EPS_NORM = 1e-5
MOMENTUM = 0.1


class SoftmaxSgAgg(torch.autograd.Function):
    """agg(h) [n, C] over the edges (send -> recv) with stop-gradient
    weights; the backward is dh[s] = sum over s's edges of relu'(h[s]) ·
    g[r] · a_e with a_e the edge's softmax weight."""

    @staticmethod
    def forward(ctx, h, send, recv, t):
        n, c = h.shape
        rng, step = plain._blocks(send.shape[0], c)
        top = torch.full((n, c), float("-inf"), dtype=h.dtype, device=h.device)
        for a in rng:
            s, r = send[a:a + step], recv[a:a + step]
            top.scatter_reduce_(0, r[:, None].expand(-1, c), t * (torch.relu(h[s]) + EPS_MSG),
                                "amax")
        num, den = torch.zeros_like(h), torch.zeros_like(h)
        for a in rng:
            s, r = send[a:a + step], recv[a:a + step]
            m = torch.relu(h[s]) + EPS_MSG
            w = torch.exp(t * m - top[r])
            den.index_add_(0, r, w)
            num.index_add_(0, r, w * m)
        pos = den > 0
        safe = torch.where(pos, den, 1.0)
        ctx.save_for_backward(h, send, recv, torch.where(pos, top + torch.log(safe), 0.0))
        ctx.t = t
        return torch.where(pos, num / safe, 0.0)

    @staticmethod
    def backward(ctx, g):
        h, send, recv, lse = ctx.saved_tensors
        n, c = h.shape
        rng, step = plain._blocks(send.shape[0], c)
        dh = torch.zeros_like(h)
        for a in rng:
            s, r = send[a:a + step], recv[a:a + step]
            hs = h[s]
            a_e = torch.exp(ctx.t * (torch.relu(hs) + EPS_MSG) - lse[r])
            dh.index_add_(0, s, torch.where(hs > 0, g[r] * a_e, 0.0))
        return dh, None, None, None


class Adam:
    """torch's Adam (no weight decay), in place on the parameters."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.state: Dict[str, Dict] = {}

    def step(self, name: str, p: torch.Tensor, g: torch.Tensor):
        st = self.state.setdefault(name, {"k": 0, "m": torch.zeros_like(p),
                                          "v": torch.zeros_like(p)})
        st["k"] += 1
        st["m"].mul_(self.b1).add_(g, alpha=1 - self.b1)
        st["v"].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        c1, c2 = 1 - self.b1 ** st["k"], 1 - self.b2 ** st["k"]
        denom = (st["v"].sqrt() / c2 ** 0.5).add_(self.eps)
        p.addcdiv_(st["m"], denom, value=-self.lr / c1)


def run(cfg: Dict, inp: Dict, device, steps: int = 3) -> Dict:
    plain.plain_precision()
    n, n_pad = int(inp["n"]), int(inp["n_pad"])
    L, t, rate = int(cfg["num_layers"]), float(cfg["t"]), float(cfg["dropout"])
    send, recv = plain.graph_edges(inp, device)
    x = torch.from_numpy(inp["x"]).to(device)
    labels = torch.from_numpy(np.asarray(inp["labels"], np.int64)).to(device)
    train_rows = plain.rows(np.asarray(inp["splits"]["train"], np.int64), device)
    W = {k: v.to(device).float().clone().requires_grad_(True)
         for k, v in inp["weights"].items()}
    names = list(W)
    gen = torch.Generator(device=device).manual_seed(int(inp["drop_seed"]))
    c = W["norms.0.weight"].shape[0]
    running = {l: [torch.zeros(c, device=device), torch.ones(c, device=device)]
               for l in range(L)}

    def linear(h, pre):
        return h @ W[pre + ".weight"].t() + W[pre + ".bias"]

    def norm(l, h, training):
        w, b = W[f"norms.{l}.weight"], W[f"norms.{l}.bias"]
        if training:
            mu, var = plain.batch_moments(h)
            with torch.no_grad():
                rm, rv = running[l]
                rm.mul_(1 - MOMENTUM).add_(MOMENTUM * mu.detach())
                rv.mul_(1 - MOMENTUM).add_(MOMENTUM * var.detach() * n / (n - 1))
        else:
            mu, var = running[l]
        return plain.affine_norm(h, mu, var, w, b, EPS_NORM)

    def conv(l, h):
        return linear(h + SoftmaxSgAgg.apply(h, send, recv, t), f"gcns.{l}.mlp.0")

    def forward(training):
        h = conv(0, linear(x, "node_features_encoder"))
        for l in range(1, L):
            a = torch.relu(norm(l - 1, h, training))
            if training:
                a = plain.dropout_ge(a, rate, gen, n_pad)
            h = h + conv(l, a)
        h = torch.relu(norm(L - 1, h, training))
        if training:
            h = plain.dropout_ge(h, rate, gen, n_pad)
        return linear(h, "node_pred_linear")

    opt = Adam(float(cfg["lr"]))
    p0 = {k: W[k].detach().clone() for k in names}
    losses, grad_norms, eval_logits = [], {}, None
    for k in range(steps):
        loss = F.cross_entropy(forward(True)[train_rows], labels[train_rows])
        grads = torch.autograd.grad(loss, [W[q] for q in names])
        losses.append(float(loss.detach()))
        if k == 0:
            grad_norms = {q: float(gr.norm()) for q, gr in zip(names, grads)}
        with torch.no_grad():
            for q, gr in zip(names, grads):
                opt.step(q, W[q], gr)
        del grads, loss
        if k == 0:
            with torch.no_grad():
                eval_logits = forward(False).cpu()
    change = {q: float((W[q].detach() - p0[q]).norm()) for q in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "eval_logits": eval_logits}
