"""Plain float32 reference of RevGAT-5L with label reuse (`examples/ogb_eff/
ogbn_arxiv_dgl` of lightaime/deep_gcns_torch, teacher mode): a first and a
last GAT conv with residuals, and L-2 grouped additive couplings

    x = [x_0 | x_1];  y_0 = x_0 + F_0(x_1);  y_1 = x_1 + F_1(y_0)
    F_i(u) = GAT(drop_shared(relu(norm(u))))

run forward as written (no inverse: the reference keeps its activations).
A GAT conv with sender-only scores and the symmetric norm:

    f = (x W_fc) / sqrt(max(outdeg, 1));  el = <f, a_l> per head
    out[r] = sqrt(max(indeg, 1))·sum_e softmax_e(leaky_relu(el[s_e]))·f[s_e] + x W_res

over the edges that the step's edge-drop keeps. The norms use the batch's
column moments in training and evaluation; the head is norm, relu, dropout,
the last conv, the mean over its head and a bias. The input is
[x | one-hot labels of the label rows]; the loss is cross entropy on the
supervised rows; RMSprop (alpha 0.99, eps 1e-8) with the linear warm-up of
the learning rate from lr/50 over the warm-up epochs. The evaluation feeds
the training rows' labels, then refines once with the argmax of the others.

Randomness follows the seeded stream in the program's order of draws: the
input dropout over the padded [n_pad, in] table (kept at draws >= rate), one
int32 key pair a layer, the shared mask over [n_pad, H·D] (kept at draws <
1 - rate) and the head's dropout (kept at draws >= rate)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import plain

SLOPE = 0.2


def run(cfg: Dict, inp: Dict, device, steps: int = 3) -> Dict:
    plain.plain_precision()
    n, n_pad = int(inp["n"]), int(inp["n_pad"])
    L, H, D, G, K = cfg["n_layers"], cfg["n_heads"], cfg["n_hidden"], cfg["group"], \
        cfg["num_classes"]
    send, recv = plain.graph_edges(inp, device)
    out_scale = plain.degree(send, n).clamp_min(1.0).pow(-0.5)[:, None, None]
    in_scale = plain.degree(recv, n).clamp_min(1.0).pow(0.5)[:, None, None]
    x = torch.from_numpy(inp["x"]).to(device)
    labels = torch.from_numpy(np.asarray(inp["labels"], np.int64)).to(device)
    train_idx = np.asarray(inp["splits"]["train"], np.int64)
    W = {k: v.to(device).float().clone().requires_grad_(True)
         for k, v in inp["weights"].items()}
    names = list(W)
    gen = torch.Generator(device=device).manual_seed(int(inp["drop_seed"]))

    def norm(pre, h):
        mu, var = plain.batch_moments(h)
        return plain.affine_norm(h, mu, var, W[pre + ".weight"], W[pre + ".bias"])

    def conv(pre, h, heads, width, key):
        f = (h @ W[pre + ".fc.weight"].t()).reshape(n, heads, width) * out_scale
        el = (f * W[pre + ".attn_l"]).sum(-1)
        s, r = send, recv
        if key is not None:
            keep = plain.edge_keep(recv, send, key, float(cfg["edge_drop"]))
            s, r = send[keep], recv[keep]
        out = plain.GATAgg.apply(el, f, s, r, SLOPE) * in_scale
        return out + (h @ W[pre + ".res_fc.weight"].t()).reshape(n, heads, width)

    def forward(xin, training):
        keys = [None] * L
        h = xin
        if training:
            h = plain.dropout_ge(h, cfg["input_drop"], gen, n_pad)
            keys = plain.drop_keys(gen, L)
        h = conv("convs.0", h, H, D, keys[0]).reshape(n, H * D)
        mask = None
        if training:
            mask = plain.shared_mask_lt(cfg["dropout"], gen, n_pad, H * D, n)
        masks = [None] * G if mask is None else list(mask.chunk(G, -1))
        for layer in range(1, L - 1):
            xs = list(h.chunk(G, -1))
            u = sum(xs[1:])
            ys = []
            for i in range(G):
                pre = f"convs.{layer}.Fms.{i}"
                a = torch.relu(norm(pre + ".norm", u))
                if masks[i] is not None:
                    a = a * masks[i]
                u = xs[i] + conv(pre + ".conv", a, H, D // G, keys[layer]).reshape(n, -1)
                ys.append(u)
            h = torch.cat(ys, -1)
        h = torch.relu(norm("norm", h))
        if training:
            h = plain.dropout_ge(h, cfg["dropout"], gen, n_pad)
        out = conv(f"convs.{L - 1}", h, 1, K, keys[L - 1])
        return out.mean(1) + W["bias_last.bias"]

    lr, warm = float(cfg["lr"]), int(cfg["warmup_epochs"])

    def lr_at(k):
        frac = 1.0 - min(k, warm) / warm
        return (lr / 50 - lr) * frac + lr

    train_rows = plain.rows(train_idx, device)
    p0 = {k: W[k].detach().clone() for k in names}
    state = {k: {} for k in names}
    losses, grad_norms, eval_logits = [], {}, None
    for k in range(steps):
        sel = np.asarray(inp["label_splits"][k])
        lab_rows = plain.rows(train_idx[sel], device)
        sup_rows = plain.rows(train_idx[~sel], device)
        xin = torch.cat([x, plain.one_hot_rows(labels, K, lab_rows, n)], 1)
        loss = F.cross_entropy(forward(xin, True)[sup_rows], labels[sup_rows])
        grads = torch.autograd.grad(loss, [W[q] for q in names])
        losses.append(float(loss.detach()))
        if k == 0:
            grad_norms = {q: float(gr.norm()) for q, gr in zip(names, grads)}
        with torch.no_grad():
            for q, gr in zip(names, grads):
                plain.rmsprop_update(W[q], gr, state[q], lr_at(k))
        if k == 0:
            with torch.no_grad():
                xin = torch.cat([x, plain.one_hot_rows(labels, K, train_rows, n)], 1)
                logits = forward(xin, False)
                soft = F.one_hot(logits.argmax(-1), K).float()
                xin = torch.cat([x, plain.one_hot_rows(labels, K, train_rows, n, soft)], 1)
                eval_logits = forward(xin, False).cpu()
    change = {q: float((W[q].detach() - p0[q]).norm()) for q in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "eval_logits": eval_logits}
