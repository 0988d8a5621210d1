"""kNN and dilated-kNN graphs of point clouds (counterpart of
`deep_gcns_torch_tpu/ops/knn.py:29-247`).

The distance is the reference's matrix form ‖x‖² − 2xxᵀ + ‖x‖²ᵀ
(`gcn_lib/dense/torch_edge.py:6-17`), a float32 `torch.matmul` with TF32
off (TF32 rounding would change which neighbours are picked), followed by
`torch.topk(..., largest=False, sorted=True)`. Both are library calls, as in
the JAX package, where they run outside any Pallas kernel. Rows are taken
1,024 at a time past that size, so the [B, N, N] matrix is never whole.

Conventions, those of the JAX package and the reference:

* a point is its own nearest neighbour (rank 0);
* dilation d keeps the ranks {0, d, 2d, …} of the k·d nearest, so the
  sorted order matters;
* stochastic dilation (training only) takes, with probability ε, k ranks
  drawn uniformly from range(k·d), one permutation for the whole batch; it
  draws from a `torch.Generator` (JAX's bits cannot be reproduced);
* kNN reads detached features (JAX's `stop_gradient`).

The approximate path (``method="approx"``) runs on the TPU's PartialReduce
unit in the JAX package; here it is the exact `torch.topk` over the same
1/d subsample of candidates (on the CPU, JAX's `approx_min_k` is exact too),
with self forced into slot 0 (`_self_first`).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch


@contextlib.contextmanager
def _no_tf32():
    """float32 products in full float32 on the card, whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pairwise_distance(x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, x [..., N, C] → [..., N, N]."""
    x = x.float()
    with _no_tf32():
        inner = -2.0 * torch.matmul(x, x.transpose(-1, -2))
    sq = (x * x).sum(-1, keepdim=True)
    return sq + inner + sq.transpose(-1, -2)


def _nearest(d: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(d, k, dim=-1, largest=False, sorted=True).indices


def knn_dense(x: torch.Tensor, k: int, row_block: int = 1024) -> torch.Tensor:
    """Ids [B, N, k] (int64) of each point's k nearest points, self included,
    by ascending distance; rows in blocks of ``row_block`` past that size."""
    x = x.detach().float()
    b, n, _ = x.shape
    if n <= row_block:
        return _nearest(pairwise_distance(x), k)
    sq_all = (x * x).sum(-1)  # [B, N]
    out = []
    for lo in range(0, n, row_block):
        xb = x[:, lo:lo + row_block]
        with _no_tf32():
            inner = -2.0 * torch.matmul(xb, x.transpose(-1, -2))
        d = inner + (xb * xb).sum(-1)[..., None] + sq_all[:, None, :]
        out.append(_nearest(d, k))
    return torch.cat(out, 1)


def _self_first(idx: torch.Tensor) -> torch.Tensor:
    """Self into slot 0 with no duplicate: the slot where the candidates
    held self (ids are distinct in a row) takes the last candidate, the last
    slot goes, self is prepended (elementwise, no sort)."""
    b, n, k = idx.shape
    self_idx = torch.arange(n, dtype=idx.dtype, device=idx.device)[None, :, None].expand(b, n, 1)
    is_self = idx == self_idx
    rest = torch.where(is_self[..., :k - 1], idx[..., k - 1:k], idx[..., :k - 1])
    return torch.cat([self_idx, rest], -1)


def _min_k_blocked(x: torch.Tensor, cand: torch.Tensor, k: int,
                   row_block: int = 4096) -> torch.Tensor:
    """The k nearest of ``cand`` [B, M, C] to each row of x [B, N, C]
    (positions in ``cand``), rows in blocks of ``row_block``."""
    sq_c = (cand * cand).sum(-1)  # [B, M]

    def block(xb):
        with _no_tf32():
            inner = -2.0 * torch.matmul(xb, cand.transpose(-1, -2))
        return _nearest(inner + (xb * xb).sum(-1)[..., None] + sq_c[:, None, :], k)

    n = x.shape[1]
    if n <= row_block:
        return block(x)
    return torch.cat([block(x[:, lo:lo + row_block]) for lo in range(0, n, row_block)], 1)


def knn_dense_approx(x: torch.Tensor, k: int) -> torch.Tensor:
    """The approximate path at d = 1: the k nearest with self forced into
    slot 0."""
    x = x.detach().float()
    return _self_first(_min_k_blocked(x, x, k))


def _dilate_ranks(idx: torch.Tensor, k: int, d: int, *, stochastic: bool, epsilon: float,
                  train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """idx [..., k·d] → [..., k]: ranks {0, d, 2d, …}, or, stochastic at train
    time with probability ε, k ranks drawn from range(k·d). Both are formed
    and one is picked on the device (no host sync)."""
    if d <= 1:
        return idx
    strided = idx[..., ::d]
    if not (stochastic and train and epsilon > 0.0):
        return strided
    gdev = generator.device if generator is not None else torch.device("cpu")
    use_random = (torch.rand((), generator=generator, device=gdev) < epsilon).to(idx.device)
    ranks = torch.randperm(k * d, generator=generator, device=gdev)[:k].to(idx.device)
    return torch.where(use_random, idx.index_select(-1, ranks), strided)


def _centers(b: int, n: int, k: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[None, :, None].expand(b, n, k)


def knn_graph_dense(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbour ids, centre ids), each [B, N, k]; the centres are the
    canonical arange (an expanded view)."""
    nn_idx = knn_dense(x, k)
    b, n, _ = nn_idx.shape
    return nn_idx, _centers(b, n, k, nn_idx.device)


def _dilated_knn_approx(x: torch.Tensor, k: int, d: int, *, train: bool,
                        generator: Optional[torch.Generator],
                        stochastic: bool = False) -> torch.Tensor:
    """kNN(k) over the 1/d subsample of candidates {off, off + d, …} (off 0,
    or drawn from range(d) at train time when stochastic), self at rank 0;
    the exact un-dilated kNN when ⌈N/d⌉ < k."""
    x = x.detach().float()
    n = x.shape[1]
    if d <= 1:
        return knn_dense_approx(x, k)
    n_cand = (n + d - 1) // d
    if n_cand < k:
        return knn_dense(x, k)
    cols = torch.arange(n_cand, device=x.device) * d
    if stochastic and train and generator is not None:
        gdev = generator.device
        cols = cols + torch.randint(0, d, (), generator=generator, device=gdev).to(x.device)
    cols = cols % n
    idx = _min_k_blocked(x, x.index_select(1, cols), k)
    return _self_first(cols[idx])


def dilated_knn_graph_dense(
    x: torch.Tensor, k: int, dilation: int = 1, *, stochastic: bool = False,
    epsilon: float = 0.0, train: bool = False, generator: Optional[torch.Generator] = None,
    method: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dilated kNN of x [B, N, C]: ([B, N, k] neighbour ids, [B, N, k]
    canonical centres). "exact" is the k·d-NN sort and stride, rank for rank
    the reference's; "approx" the candidate subsample (`_dilated_knn_approx`)."""
    b, n, _ = x.shape
    if method == "approx":
        nn_idx = _dilated_knn_approx(x, k, dilation, train=train, generator=generator,
                                     stochastic=stochastic)
    else:
        nn_idx = _dilate_ranks(knn_dense(x, k * dilation), k, dilation,
                               stochastic=stochastic, epsilon=epsilon, train=train,
                               generator=generator)
    return nn_idx, _centers(b, n, k, nn_idx.device)


def dilated_knn_graph_flat(
    x: torch.Tensor, k: int, dilation: int = 1, *, num_nodes_per_graph: int,
    stochastic: bool = False, epsilon: float = 0.0, train: bool = False,
    generator: Optional[torch.Generator] = None, method: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat kNN of equally sized graphs stacked in x [B·n, C] (reference
    `knn_graph_matrix`, `gcn_lib/sparse/torch_edge.py:66-104`): per-graph
    kNN plus batch offsets, as int32 (senders, receivers) with the receivers
    centre-major (sorted)."""
    total, c = x.shape
    n = num_nodes_per_graph
    b = total // n
    nn_idx, _ = dilated_knn_graph_dense(x.reshape(b, n, c), k, dilation,
                                        stochastic=stochastic, epsilon=epsilon, train=train,
                                        generator=generator, method=method)
    offs = (torch.arange(b, device=nn_idx.device) * n)[:, None, None]
    senders = (nn_idx + offs).reshape(-1).int()
    receivers = torch.arange(total, dtype=torch.int32, device=x.device).repeat_interleave(k)
    return senders, receivers
