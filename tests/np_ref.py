"""Pure-numpy golden implementations of the reference's scatter semantics
(torch_scatter / utils/pyg_util.py) used to validate the JAX/Pallas kernels."""

import numpy as np


def scatter_ref(name, src, index, dim_size):
    """src [E, C], index [E] → [dim_size, C] with torch_scatter semantics:
    empty segments = 0 for all reductions."""
    E, C = src.shape
    out = np.zeros((dim_size, C), src.dtype)
    if name in ("add", "sum"):
        np.add.at(out, index, src)
        return out
    if name == "mean":
        np.add.at(out, index, src)
        cnt = np.bincount(index, minlength=dim_size).reshape(-1, 1)
        return out / np.maximum(cnt, 1)
    if name in ("max", "min"):
        fill = -np.inf if name == "max" else np.inf
        acc = np.full((dim_size, C), fill, src.dtype)
        ufunc = np.maximum if name == "max" else np.minimum
        ufunc.at(acc, index, src)
        acc[~np.isfinite(acc)] = 0
        return acc
    raise ValueError(name)


def scatter_softmax_ref(src, index, dim_size):
    """Per-(segment, channel) softmax weights (torch_scatter.scatter_softmax)."""
    mx = np.full((dim_size, src.shape[1]), -np.inf, src.dtype)
    np.maximum.at(mx, index, src)
    mx[~np.isfinite(mx)] = 0
    e = np.exp(src - mx[index])
    den = np.zeros((dim_size, src.shape[1]), src.dtype)
    np.add.at(den, index, e)
    return e / np.maximum(den[index], np.finfo(src.dtype).tiny)


def gen_aggregate_ref(msgs, index, dim_size, aggr="softmax", t=1.0, p=1.0, y=0.0):
    """GenMessagePassing.aggregate (`gcn_lib/sparse/torch_message.py:44-85`)."""
    if aggr in ("add", "sum", "mean", "max", "min"):
        return scatter_ref(aggr, msgs, index, dim_size)
    if aggr in ("softmax", "softmax_sg", "softmax_sum"):
        w = scatter_softmax_ref(msgs * t, index, dim_size)
        out = scatter_ref("sum", msgs * w, index, dim_size)
        if aggr == "softmax_sum":
            deg = np.bincount(index, minlength=dim_size).reshape(-1, 1)
            out = deg ** (1 / (1 + np.exp(-y))) * out
        return out
    if aggr in ("power", "power_sum"):
        m = np.clip(msgs, 1e-7, 1e1)
        out = scatter_ref("mean", m ** p, index, dim_size)
        out = np.clip(out, 1e-7, 1e1) ** (1 / p)
        if aggr == "power_sum":
            deg = np.bincount(index, minlength=dim_size).reshape(-1, 1)
            out = deg ** (1 / (1 + np.exp(-y))) * out
        return out
    raise ValueError(aggr)


def with_top_sender(x, senders, receivers):
    """The graph with nodes 0, 1, ... made every channel's largest value
    (x.max + 1) and each sending to 10 consecutive receivers, so that every
    node receives from one: each receiver's largest message is then the
    global one, so a per-receiver softmax shift equals the global shift of
    the JAX package's kernels, and the two compute the same terms. No
    sender's row grows by more than 10 edges."""
    n = x.shape[0]
    x = x.copy()
    top = np.arange(n) // 10
    x[top[0]:top[-1] + 1] = x.max(0) + 1.0
    senders = np.concatenate([senders, top.astype(senders.dtype)])
    receivers = np.concatenate([receivers, np.arange(n, dtype=receivers.dtype)])
    return x, senders, receivers


def random_graph(rng, n, e, c, sort=True):
    """Random COO graph with features; receivers sorted."""
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = rng.integers(0, n, e).astype(np.int32)
    if sort:
        order = np.argsort(receivers, kind="stable")
        senders, receivers = senders[order], receivers[order]
    x = rng.standard_normal((n, c)).astype(np.float32)
    return x, senders, receivers
