"""Plain float32 PyTorch pieces that the references share: the graph worked
out again from the raw edges, the dropout and edge-drop draws of a seeded
stream, masked moments, the attention aggregation with its backward written
out in blocks of edges (so that no [E, C] tensor is kept for autograd), and
the optimizer's update rule.

Imports nothing of this repository's packages."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# elements of an edge block's widest temporary ([edges, channels])
BLOCK_ELEMS = 1 << 26


def plain_precision():
    """IEEE float32 products: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def graph_edges(inp: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(senders, receivers) int64 on ``device``: the raw directed edges made
    symmetric without duplicates, every self-loop dropped, then one self-loop
    a node; ids relabelled to the program's row order when the harness gives
    ``perm`` (row i holds node perm[i])."""
    n = int(inp["n"])
    s0 = torch.from_numpy(np.asarray(inp["senders"], np.int64)).to(device)
    r0 = torch.from_numpy(np.asarray(inp["receivers"], np.int64)).to(device)
    s, r = torch.cat([s0, r0]), torch.cat([r0, s0])
    key = torch.unique(s * n + r)
    s, r = key // n, key % n
    keep = s != r
    loop = torch.arange(n, device=device)
    s, r = torch.cat([s[keep], loop]), torch.cat([r[keep], loop])
    if inp.get("perm") is not None:
        new_of_old = torch.empty(n, dtype=torch.int64, device=device)
        new_of_old[torch.from_numpy(np.asarray(inp["perm"], np.int64)).to(device)] = loop
        s, r = new_of_old[s], new_of_old[r]
    return s, r


def degree(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(idx, minlength=n).float()


def uniform_rows(gen: torch.Generator, n_pad: int, cols: int, n: int) -> torch.Tensor:
    """The stream's next uniform draws over the program's padded [n_pad, cols]
    node table; the n valid rows."""
    return torch.rand((n_pad, cols), generator=gen, device=gen.device)[:n]


def dropout_ge(h: torch.Tensor, rate: float, gen: torch.Generator, n_pad: int) -> torch.Tensor:
    """Inverted dropout that keeps an entry where its draw is >= rate."""
    keep = uniform_rows(gen, n_pad, h.shape[1], h.shape[0]) >= rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros((), device=h.device))


def shared_mask_lt(rate: float, gen: torch.Generator, n_pad: int, cols: int, n: int):
    """A dropout mask that keeps an entry where its draw is < 1 - rate,
    scaled by 1 / (1 - rate)."""
    return (uniform_rows(gen, n_pad, cols, n) < 1.0 - rate).float() / (1.0 - rate)


def drop_keys(gen: torch.Generator, layers: int):
    """One int32 key pair a layer from the stream."""
    return torch.randint(-2 ** 31, 2 ** 31, (layers, 2), generator=gen, device=gen.device,
                         dtype=torch.int64).tolist()


_M32 = 0xFFFFFFFF


def edge_keep(recv: torch.Tensor, send: torch.Tensor, key, rate: float) -> torch.Tensor:
    """The edge-drop decision of (receiver, sender, key pair): a counter-based
    hash on 32-bit patterns, kept where its low 31 bits reach floor(rate·2^31)."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    h = (recv * 0x9E3779B9 + k0) & _M32
    h = h ^ ((send * 0x85EBCA6B + k1) & _M32)
    h = h ^ (h >> 16)
    h = (h * 668265295) & _M32
    h = h ^ (h >> 15)
    return (h & 0x7FFFFFFF) >= min(int(rate * 2147483648.0), 2147483647)


def batch_moments(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column mean and biased variance over the rows (two passes)."""
    mu = h.mean(0)
    return mu, ((h - mu) ** 2).mean(0)


def affine_norm(h, mu, var, w, b, eps: float = 1e-5):
    return (h - mu) / torch.sqrt(var + eps) * w + b


def _blocks(e: int, width: int):
    step = max(1, BLOCK_ELEMS // max(width, 1))
    return range(0, e, step), step


class GATAgg(torch.autograd.Function):
    """out[r, h] = sum over edges (s -> r) of alpha_{e,h}·v[s, h, :] with alpha
    the softmax over r's edges of leaky_relu(el[s, h]); 0 for a receiver with
    no edge. Gradients for el and v."""

    @staticmethod
    def forward(ctx, el, v, send, recv, slope):
        n, h, d = v.shape
        rng, step = _blocks(send.shape[0], h * d)
        mx = torch.full((n, h), -float("inf"), dtype=v.dtype, device=v.device)
        for a in rng:
            s, r = send[a:a + step], recv[a:a + step]
            mx.scatter_reduce_(0, r[:, None].expand(-1, h), F.leaky_relu(el[s], slope), "amax")
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        num, den = torch.zeros_like(v), torch.zeros((n, h), dtype=v.dtype, device=v.device)
        for a in rng:
            s, r = send[a:a + step], recv[a:a + step]
            w = torch.exp(F.leaky_relu(el[s], slope) - mx[r])
            den.index_add_(0, r, w)
            num.index_add_(0, r, w[..., None] * v[s])
        den_safe = torch.where(den > 0, den, 1.0)
        out = torch.where((den > 0)[..., None], num / den_safe[..., None], 0.0)
        ctx.save_for_backward(el, v, mx, den_safe, out, send, recv)
        ctx.slope = slope
        return out

    @staticmethod
    def backward(ctx, g):
        el, v, mx, den, out, send, recv = ctx.saved_tensors
        slope = ctx.slope
        n, h, d = v.shape
        o = (g * out).sum(-1)
        dv, d_el = torch.zeros_like(v), torch.zeros_like(el)
        rng, step = _blocks(send.shape[0], h * d)
        for a in rng:
            s, r = send[a:a + step], recv[a:a + step]
            sc = el[s]
            alpha = torch.exp(F.leaky_relu(sc, slope) - mx[r]) / den[r]
            gr = g[r]
            dv.index_add_(0, s, alpha[..., None] * gr)
            d_score = alpha * ((gr * v[s]).sum(-1) - o[r])
            d_el.index_add_(0, s, d_score * torch.where(sc >= 0, 1.0, slope))
        return d_el, dv, None, None, None


def rmsprop_update(p, g, state: dict, lr: float, alpha: float = 0.99, eps: float = 1e-8):
    """RMSprop (eps outside the square root, no momentum), in place."""
    sq = state.setdefault("sq", torch.zeros_like(p))
    sq.mul_(alpha).addcmul_(g, g, value=1 - alpha)
    p.sub_(lr * g / (sq.sqrt() + eps))


def rows(mask_idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(mask_idx, np.int64)).to(device)


def one_hot_rows(labels: torch.Tensor, k: int, rows_idx: Optional[torch.Tensor],
                 n: int, other: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, k]: the one-hot label of each row in ``rows_idx``, ``other`` (zeros
    when None) elsewhere."""
    out = torch.zeros((n, k), device=labels.device) if other is None else other.clone()
    if rows_idx is not None:
        out[rows_idx] = F.one_hot(labels[rows_idx], k).float()
    return out
