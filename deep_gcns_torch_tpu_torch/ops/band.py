"""Band-dense SpMM: the gather-free aggregation route for locality-ordered
graphs (counterpart of `deep_gcns_torch_tpu/ops/band.py:49-1015`).

Host side (numpy, with the native library for the hot loops): for each
128-row receiver block, pick the length-W source window that covers the most
edges and store that block's adjacency densely as an int8 count matrix
A[128, W]. Power-law graphs also get dense hub corrections: the columns of
the top out-degree senders (``a_hub``) and the complete rows of the top
in-degree receivers (``a_row``). Whatever is left goes to a small leftover
CSR. The arrays are bit for bit the JAX package's for the same edges.

Device side: `_band_all` computes A @ x as
  1. K3 (`csrc/band.cu`, `band_call`): the per-block window product;
  2. + the hub-column product, a `torch.mm` of the int8 counts turned to x's
     dtype (float32 accumulation);
  3. `index_add_` of the hub-row product;
  4. + the leftover through K1's gathered form (`csr_seg_sum(x, lo_row_ptr,
     lo_src)`), which never writes an [E_lo, C] intermediate,
in the JAX package's order of roundings. `band_spmm` and `band_softmax_agg`
are autograd Functions whose backward is `_band_all` on the transpose band.

On the TPU the route exists because XLA's row gather is issue-rate bound
(`ops/band.py:3-22` of the JAX package). Whether it pays on the H100 is
measured by `chip_smoke.py`; the gate thresholds tuned on the TPU stay as
they are, so that the port's arrays and routes match the JAX package's.
`band_gat_agg` serves the sender-only-score GAT through `band_sum_auto`, and
`band_gat_dense_agg` the destination-score GAT (and the per-receiver
stabilizer) through `ops/gat_dense.py` (K7–K9 over the window band and its
hub columns). `band_extreme` is the max/min of a node table over each
receiver's edges on a hub-free band: a masked reduce over each block's
window plus the leftover, plain PyTorch as it is XLA in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from .. import native
from ..graph import _tensor
from ..nn.core import mm_f32
from ._build import library
from .route_misses import miss
from .spmm_cuda import (_SUFFIX, _check_index, _raise_on, _require, csr_seg_sum,
                        csr_seg_sum_plain)

BN = 128        # receiver rows per block
ALIGN = 16      # window-start alignment
CHUNK = 512     # leftover CSR padding multiple (the JAX package's spmm_pallas.CHUNK)

IntLike = Union[int, torch.Tensor]


@dataclass(frozen=True)
class Band:
    """One direction's band structure (A or Aᵀ) and its off-band leftover.

    Tensor fields (int32 ids, int8 counts; bf16 hub counts on the card), as
    `deep_gcns_torch_tpu/ops/band.py:55-101` lays them out:

      w_lo [NB]              window start of each receiver block (ALIGN multiple)
      a [NB*BN, W]           edge counts, row = receiver, col = sender - w_lo
      lo_src, lo_dst [E_lo_pad], lo_row_ptr [N_pad + 1]
                             leftover edges as a receiver-sorted CSR,
                             sentinel-padded (N_pad) to a CHUNK multiple
      hub_ids [H], a_hub [N_pad, H]        hub-column senders and counts
      hub_row_ids [R], a_row [R, N_pad]    hub-row receivers and full rows
      a_t [NB*W, BN], a_hub_t [H, N_pad]   the JAX package's transposed tiles of
                                           its dense GAT kernels, kept on the host:
                                           K7–K9 read ``a`` and ``a_hub`` row-major

    Hub fields are None when no node crosses the degree threshold."""

    w_lo: torch.Tensor
    a: torch.Tensor
    lo_src: torch.Tensor
    lo_dst: torch.Tensor
    lo_row_ptr: torch.Tensor
    hub_ids: Optional[torch.Tensor] = None
    a_hub: Optional[torch.Tensor] = None
    hub_row_ids: Optional[torch.Tensor] = None
    a_row: Optional[torch.Tensor] = None
    a_t: Optional[torch.Tensor] = None
    a_hub_t: Optional[torch.Tensor] = None
    window: int = 512
    n_edges: int = 0
    n_lo: int = 0
    n_hub: int = 0       # edges carried by hub columns
    n_hub_row: int = 0   # edges carried by hub rows

    @property
    def coverage(self) -> float:
        """Fraction of edges carried gather-free (window band and hubs)."""
        return 1.0 - self.n_lo / max(self.n_edges, 1)

    def tensors(self):
        """The tensors `to` moves: every tensor field but the host-only
        transposed tiles."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in _HOST_ONLY
                and isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device) -> "Band":
        """The band on ``device``: the transposed tiles stay on the host, and
        the hub count matrices take the dtype `HUB_COUNTS_DTYPE` names for
        the device type (unchanged where it names none)."""
        device = torch.device(device)
        moved = {k: v.to(device) for k, v in self.tensors().items()}
        dtype = HUB_COUNTS_DTYPE.get(device.type)
        if dtype is not None:
            moved.update({k: moved[k].to(dtype) for k in _HUB_COUNTS if k in moved})
        return dataclasses.replace(self, **moved)

    def nbytes(self) -> int:
        """Bytes of the tensors `to` moves, in their present dtypes."""
        return sum(v.numel() * v.element_size() for v in self.tensors().values())


# the transposed count tiles of the JAX package's dense GAT kernels: built
# for parity with its arrays and kept on the host, since the port's kernels
# (K7–K9) read the row-major counts
_HOST_ONLY = ("a_t", "a_hub_t")
_HUB_COUNTS = ("a_hub", "a_row")
# on the card the hub counts are held in bf16, the dtype of the main path's
# hub products (counts up to 127 are exact in it), so no call converts them;
# a float32 caller widens them per call
HUB_COUNTS_DTYPE = {"cuda": torch.bfloat16}


@dataclass(frozen=True)
class BandPair:
    """Forward (A) and transpose (Aᵀ) bands: what the backward needs."""

    fwd: Band
    bwd: Band

    def to(self, device) -> "BandPair":
        return BandPair(self.fwd.to(device), self.bwd.to(device))

    def nbytes(self) -> int:
        return self.fwd.nbytes() + self.bwd.nbytes()


# ---------------------------------------------------------------------------
# hash edge-drop
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DropSpec:
    """Per-step edge-drop: an edge is kept when a counter-based hash of
    (recv, send, k0, k1) clears ``thresh``, so the band, its transpose, the
    hubs and the leftover agree on which edges dropped without an [E] mask
    (`ops/band.py:121-137`). ``k0``/``k1`` are int32 values (Python ints or
    one-element tensors)."""

    k0: IntLike
    k1: IntLike
    thresh: int   # floor(p_drop · 2³¹)


def drop_thresh(drop_p: float) -> int:
    return min(int(drop_p * 2147483648.0), 2147483647)


_MASK32 = 0xFFFFFFFF


def _u32(v) -> Union[int, torch.Tensor]:
    """An int32 value (or tensor) as its uint32 bit pattern, in int64."""
    if isinstance(v, torch.Tensor):
        return v.long() & _MASK32
    return int(v) & _MASK32


def _hash_keep(recv: torch.Tensor, send: torch.Tensor, k0: IntLike, k1: IntLike,
               thresh: int) -> torch.Tensor:
    """Bool keep mask from int32 id planes, bit for bit `_hash_keep`
    (`ops/band.py:158-165`). The JAX version's int32 products wrap and its
    shifts are logical; torch's int32 `>>` is arithmetic, so the hash runs on
    uint32 bit patterns held in int64 and masked to 32 bits after each step
    (int64 products that overflow wrap, which keeps the low 32 bits). The
    third multiplier is the JAX code's decimal 668265295 (0x27D4EB4F; its
    comment there says 0x27D4EB2F)."""
    h = (_u32(recv) * 0x9E3779B9 + _u32(k0)) & _MASK32
    h = h ^ ((_u32(send) * 0x85EBCA6B + _u32(k1)) & _MASK32)
    h = h ^ (h >> 16)
    h = (h * 668265295) & _MASK32
    h = h ^ (h >> 15)
    return (h & 0x7FFFFFFF) >= thresh


def edge_keep_mask(drop: Optional[DropSpec], receivers: torch.Tensor,
                   senders: torch.Tensor) -> Optional[torch.Tensor]:
    """[E] float keep mask for the per-edge paths: the same draws the band
    kernel makes."""
    if drop is None:
        return None
    return _hash_keep(receivers, senders, drop.k0, drop.k1, drop.thresh).float()


# ---------------------------------------------------------------------------
# host-side build
# ---------------------------------------------------------------------------

AUTO_WINDOWS = (256, 512, 768, 1024, 1536, 2048)
HUB_DEGREE = 256    # "auto" hub threshold
MAX_HUBS = 4096     # per direction and kind


def _round_down(x: int, m: int) -> int:
    return (x // m) * m


def _pick_window(s, blk_start, nb, n_pad) -> int:
    """Smallest candidate window reaching ≥ 99% coverage, else the candidate
    maximising covered_edges − window·NB·BN/1536 (the divisor is the JAX
    package's TPU break-even, `ops/band.py:182-206`)."""
    cands = [w for w in AUTO_WINDOWS if w <= n_pad] or [n_pad]
    covered = np.zeros(len(cands), np.int64)
    for b in range(nb):
        a, z = blk_start[b], blk_start[b + 1]
        if a == z:
            continue
        ss = s[a:z]
        for j, w in enumerate(cands):
            hi = np.searchsorted(ss, ss + w, side="left")
            covered[j] += int((hi - np.arange(len(ss))).max())
    n_edges = blk_start[-1]
    for j, w in enumerate(cands):
        if covered[j] >= 0.99 * n_edges:
            return w
    score = covered - np.asarray(cands, np.int64) * (nb * BN) // 1536
    return cands[int(np.argmax(score))]


def _top_degree(ids: np.ndarray, n: int, thr: int, cap: int) -> np.ndarray:
    """Nodes appearing ≥ thr times in ids, highest degree first, at most cap."""
    deg = np.bincount(ids, minlength=n)
    cand = np.flatnonzero(deg >= thr)
    if cand.size > cap:
        cand = cand[np.argsort(deg[cand])[::-1][:cap]]
    return cand.astype(np.int64)


def _pad128(ids: np.ndarray) -> np.ndarray:
    """0-pad to a multiple of 128 (padded entries get all-zero A slices)."""
    pad = (-len(ids)) % 128
    return np.concatenate([ids, np.zeros(pad, ids.dtype)]) if pad else ids


def _cat(a, b):
    return b if a is None else np.concatenate([a, b])


def _build_one(senders: np.ndarray, receivers: np.ndarray, n_pad: int, window,
               hub_degree=None) -> Band:
    n_edges_total = len(senders)
    if hub_degree == "auto":
        hub_degree = HUB_DEGREE

    # hub ROWS first: a hub row owns all its incoming edges, those from hub
    # senders included (the dense row product computes the complete row)
    hub_row_ids = a_row = None
    n_hub_row = 0
    extra_row_s = extra_row_r = None
    if hub_degree and n_edges_total:
        rows = _top_degree(receivers, n_pad, hub_degree, MAX_HUBS)
        if rows.size:
            row_of = np.full(n_pad, -1, np.int64)
            row_of[rows] = np.arange(rows.size)
            on_row = row_of[receivers] >= 0
            a_row32 = np.zeros((len(rows), n_pad), np.int32)
            np.add.at(a_row32, (row_of[receivers[on_row]], senders[on_row]), 1)
            over = a_row32 > 127
            if over.any():  # multi-edge overflow rides the leftover CSR
                rr, cc = np.nonzero(over)
                rep = a_row32[rr, cc] - 127
                extra_row_r = np.repeat(rows[rr], rep)
                extra_row_s = np.repeat(cc, rep)
                a_row32[rr, cc] = 127
            n_hub_row = int(on_row.sum())
            hub_row_ids = _pad128(rows).astype(np.int32)
            a_row = np.zeros((len(hub_row_ids), n_pad), np.int8)
            a_row[:len(rows)] = a_row32.astype(np.int8)
            senders, receivers = senders[~on_row], receivers[~on_row]

    # hub COLUMNS on the residual (top out-degree senders)
    hub_ids = a_hub = None
    n_hub = 0
    if hub_degree and len(senders):
        cols = _top_degree(senders, n_pad, hub_degree, MAX_HUBS)
        if cols.size:
            col_of = np.full(n_pad, -1, np.int64)
            col_of[cols] = np.arange(cols.size)
            on_col = col_of[senders] >= 0
            ah32 = np.zeros((n_pad, len(cols)), np.int32)
            np.add.at(ah32, (receivers[on_col], col_of[senders[on_col]]), 1)
            over = ah32 > 127
            if over.any():
                rr, cc = np.nonzero(over)
                rep = ah32[rr, cc] - 127
                extra_row_r = _cat(extra_row_r, np.repeat(rr, rep))
                extra_row_s = _cat(extra_row_s, np.repeat(cols[cc], rep))
                ah32[rr, cc] = 127
            n_hub = int(on_col.sum())
            hub_ids = _pad128(cols).astype(np.int32)
            a_hub = np.zeros((n_pad, len(hub_ids)), np.int8)
            a_hub[:, :len(cols)] = ah32.astype(np.int8)
            senders, receivers = senders[~on_col], receivers[~on_col]

    band = _build_window(senders, receivers, n_pad, window, extra_s=extra_row_s,
                         extra_r=extra_row_r, n_edges_total=n_edges_total)
    return dataclasses.replace(band, hub_ids=_tensor(hub_ids), a_hub=_tensor(a_hub),
                               hub_row_ids=_tensor(hub_row_ids), a_row=_tensor(a_row),
                               n_hub=n_hub, n_hub_row=n_hub_row)


def _build_window(senders: np.ndarray, receivers: np.ndarray, n_pad: int, window,
                  extra_s=None, extra_r=None, n_edges_total: Optional[int] = None) -> Band:
    nb = n_pad // BN
    n_edges = len(senders) if n_edges_total is None else n_edges_total
    rb = receivers // BN
    order = np.lexsort((senders, rb))
    s, r, rbo = senders[order], receivers[order], rb[order]
    blk_start = np.searchsorted(rbo, np.arange(nb + 1))

    cands = ([w for w in AUTO_WINDOWS if w <= n_pad] or [n_pad]) \
        if window == "auto" else [window]
    res = native.band_windows(s, blk_start, n_pad, cands,
                              0.99 if window == "auto" else 0.0, 1536, ALIGN)
    if res is not None:
        window, w_lo, in_band = res
    else:
        if window == "auto":
            window = _pick_window(s, blk_start, nb, n_pad)
        w_lo = np.zeros(nb, np.int32)
        in_band = np.zeros(len(s), bool)
        for b in range(nb):
            a, z = blk_start[b], blk_start[b + 1]
            if a == z:
                continue
            ss = s[a:z]  # sorted ascending within the block
            hi = np.searchsorted(ss, ss + window, side="left")
            i = int(np.argmax(hi - np.arange(len(ss))))
            lo = _round_down(int(ss[i]), ALIGN)
            lo = min(max(lo, 0), n_pad - window)
            w_lo[b] = lo
            in_band[a:z] = (ss >= lo) & (ss < lo + window)

    # int8 counts, saturating at 127; the excess spills to the leftover
    counted = native.band_counts(s, r, in_band, w_lo, window, BN, nb * BN)
    if counted is not None:
        a_band, sp_s, sp_r = counted
        if len(sp_s):
            extra_s = _cat(extra_s, sp_s.astype(np.int64))
            extra_r = _cat(extra_r, sp_r.astype(np.int64))
    else:
        a_band = np.zeros((nb * BN, window), np.int32)
        sb, rb_b = s[in_band], r[in_band]
        np.add.at(a_band, (rb_b, sb - w_lo[rb_b // BN]), 1)
        over = a_band > 127
        if over.any():
            rows, cols = np.nonzero(over)
            rep = a_band[rows, cols] - 127
            extra_r = _cat(extra_r, np.repeat(rows, rep).astype(np.int64))
            extra_s = _cat(extra_s, np.repeat(cols + w_lo[rows // BN], rep).astype(np.int64))
            a_band[rows, cols] = 127
        a_band = a_band.astype(np.int8)

    lo_s = s[~in_band]
    lo_r = r[~in_band]
    if extra_s is not None:
        lo_s = np.concatenate([lo_s, np.asarray(extra_s, np.int64)])
        lo_r = np.concatenate([lo_r, np.asarray(extra_r, np.int64)])
    n_lo = len(lo_s)
    # leftover CSR: receiver-sorted, sentinel-padded to a CHUNK multiple
    lo_order = np.argsort(lo_r, kind="stable")
    lo_s, lo_r = lo_s[lo_order], lo_r[lo_order]
    e_lo_pad = max(-(-max(n_lo, 1) // CHUNK) * CHUNK, CHUNK)
    sentinel = np.int32(n_pad)
    lo_src = np.full(e_lo_pad, sentinel, np.int32)
    lo_dst = np.full(e_lo_pad, sentinel, np.int32)
    lo_src[:n_lo] = lo_s
    lo_dst[:n_lo] = lo_r
    counts = np.bincount(lo_r.astype(np.int64), minlength=n_pad) if n_lo else \
        np.zeros(n_pad, np.int64)
    lo_row_ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=lo_row_ptr[1:])
    return Band(w_lo=_tensor(w_lo), a=_tensor(a_band), lo_src=_tensor(lo_src),
                lo_dst=_tensor(lo_dst), lo_row_ptr=_tensor(lo_row_ptr.astype(np.int32)),
                window=int(window), n_edges=n_edges, n_lo=n_lo)


def _with_transposes(band: Band) -> Band:
    """Attach the host-transposed count tiles the dense GAT kernels read."""
    n_pad, w = band.a.shape
    nb = n_pad // BN
    a_t = np.ascontiguousarray(band.a.numpy().reshape(nb, BN, w).swapaxes(1, 2))
    a_hub_t = (np.ascontiguousarray(band.a_hub.numpy().T)
               if band.a_hub is not None else None)
    return dataclasses.replace(band, a_t=_tensor(a_t.reshape(-1, BN)),
                               a_hub_t=_tensor(a_hub_t))


def build_band_pair(senders: np.ndarray, receivers: np.ndarray, n_pad: int,
                    window="auto", hubs="auto") -> BandPair:
    """Host-side band structures for A (forward) and Aᵀ (backward), as CPU
    tensors (move them with `.to`).

    senders/receivers are the VALID edges only; n_pad is a BN multiple;
    window a 128-multiple (clamped to n_pad) or "auto" (per-direction scan
    over AUTO_WINDOWS). ``hubs``: "auto" extracts nodes of degree ≥ 256 into
    dense hub products, an int sets the threshold, None disables. The
    transposed tiles of the dense GAT route are built too, as the JAX
    package's default builds them."""
    assert n_pad % BN == 0, n_pad
    if window != "auto":
        window = min(window, n_pad)
        assert window % 128 == 0 and window > 0, window
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    fwd = _build_one(senders, receivers, n_pad, window, hubs)
    bwd = _build_one(receivers, senders, n_pad, window, hubs)
    return BandPair(fwd=_with_transposes(fwd), bwd=_with_transposes(bwd))


# ---------------------------------------------------------------------------
# K3: the per-block window product
# ---------------------------------------------------------------------------

def _drop_planes(rows: torch.Tensor, cols: torch.Tensor, drop: DropSpec, swap: bool):
    recv, send = (cols, rows) if swap else (rows, cols)
    return _hash_keep(recv, send, drop.k0, drop.k1, drop.thresh)


def band_call_plain(x: torch.Tensor, band: Band, drop: Optional[DropSpec] = None,
                    swap: bool = False) -> torch.Tensor:
    """K3's function in torch (the counterpart of `_band_call_xla`,
    `ops/band.py:487-508`): for each 128-row block b,
    out[b] = A[b] @ x[w_lo[b] : w_lo[b] + W], with the hash-drop plane
    zeroing counts (``swap`` exchanges receiver and sender ids, for the
    transpose band). The counts and bf16 values are exact in float32, so the
    product runs in float32 and rounds once to x's dtype."""
    n_pad, c = x.shape
    w = band.window
    nb = n_pad // BN
    ar = torch.arange(w, device=x.device)
    win = x.index_select(0, (band.w_lo.long()[:, None] + ar).reshape(-1)).reshape(nb, w, c)
    a = band.a.reshape(nb, BN, w).float()
    if drop is not None:
        rows = torch.arange(nb * BN, device=x.device).reshape(nb, BN, 1)
        cols = band.w_lo.long().reshape(nb, 1, 1) + ar.reshape(1, 1, w)
        a = a * _drop_planes(rows, cols, drop, swap)
    return torch.bmm(a, win.float()).reshape(n_pad, c).to(x.dtype)


def band_call(x: torch.Tensor, band: Band, drop: Optional[DropSpec] = None,
              swap: bool = False) -> torch.Tensor:
    """K3 (`csrc/band.cu`) on a CUDA tensor; the plain version on a CPU one."""
    if x.device.type == "cpu":
        return band_call_plain(x, band, drop, swap)
    _require(x.device.type == "cuda", "x must be a CUDA tensor")
    _require(x.dtype in _SUFFIX, f"x must be float32 or bfloat16, got {x.dtype}")
    _require(x.ndim == 2 and x.is_contiguous(), "x must be 2-D contiguous")
    n_pad, c = x.shape
    w = band.window
    a = band.a
    _require(n_pad % BN == 0 and a.shape == (n_pad, w),
             f"band.a is {tuple(a.shape)}, expected ({n_pad}, {w})")
    _require(a.device == x.device and a.dtype == torch.int8 and a.is_contiguous(),
             "band.a must be contiguous int8 on x's device")
    _require(w % 128 == 0 and w < (1 << 23) and a.data_ptr() % 16 == 0,
             "the window must be a 128-multiple below 2^23 and A 16-byte aligned")
    _check_index("band.w_lo", band.w_lo, x.device)
    _require(band.w_lo.shape[0] == n_pad // BN, "band.w_lo must have N_pad/128 entries")
    out = torch.empty_like(x)
    if n_pad == 0 or c == 0:
        return out
    vec = 4 if c % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    k0, k1, thresh = (0, 0, -1) if drop is None else (
        int(drop.k0), int(drop.k1), int(drop.thresh))
    fn = getattr(library("band"), f"dgc_band_{_SUFFIX[x.dtype]}")
    rc = fn(a.data_ptr(), band.w_lo.data_ptr(), x.data_ptr(), out.data_ptr(), n_pad, w,
            c, vec, k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF, thresh, int(bool(swap)),
            torch.cuda.current_stream(x.device).cuda_stream)
    band_call.launches += 1
    _raise_on(rc, "K3 band")
    return out


band_call.launches = 0


# ---------------------------------------------------------------------------
# A @ x over every structure, and the Functions around it
# ---------------------------------------------------------------------------

def _hub_dot(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense count × features product (counts in x's dtype, where they are
    exact), accumulated in float32 and rounded once to x's dtype
    (`_hub_dot`, `ops/band.py:550-559`)."""
    return mm_f32(a, x).to(x.dtype)


def _band_all(x: torch.Tensor, band: Band, drop: Optional[DropSpec], swap: bool,
              call: Callable, seg: Callable) -> torch.Tensor:
    """Full A @ x: window band (``call``: K3 or its plain version), hub
    columns, hub rows, then the leftover through ``seg`` (K1 or its plain
    version), in the JAX package's order (`ops/band.py:562-607`). Not
    differentiable: the callers' backward runs it on the transpose band."""
    n_pad = x.shape[0]
    out = call(x, band, drop, swap)
    if band.hub_ids is not None:
        x_hub = x.index_select(0, band.hub_ids.long())
        a_hub = band.a_hub
        if drop is not None:
            rows = torch.arange(n_pad, device=x.device)[:, None]
            a_hub = a_hub * _drop_planes(rows, band.hub_ids.long()[None, :], drop, swap)
        out = out + _hub_dot(a_hub.to(x.dtype), x_hub)
    if band.hub_row_ids is not None:
        # padded hub rows are all-zero, so their id-0 slots add zeros
        a_row = band.a_row
        if drop is not None:
            cols = torch.arange(n_pad, device=x.device)[None, :]
            a_row = a_row * _drop_planes(band.hub_row_ids.long()[:, None], cols, drop, swap)
        out = out.index_add(0, band.hub_row_ids.long(), _hub_dot(a_row.to(x.dtype), x))
    if band.n_lo:
        if drop is None:
            # gathered form: K1 reads x[lo_src[e]] for e in [0, n_lo) only,
            # so the sentinel padding is never gathered
            lo = seg(x, band.lo_row_ptr, band.lo_src)
        else:
            n = band.n_lo
            src, dst = band.lo_src[:n], band.lo_dst[:n]
            keep = _drop_planes(dst, src, drop, swap)
            msgs = x.index_select(0, src.long()) * keep[:, None].to(x.dtype)
            lo = seg(msgs.contiguous(), band.lo_row_ptr)
        out = out + lo
    return out


_KERNELS = (band_call, csr_seg_sum)
_PLAIN = (band_call_plain, csr_seg_sum_plain)


class _BandSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bands, drop, ops):
        ctx.bwd, ctx.drop, ctx.ops = bands.bwd, drop, ops
        return _band_all(x, bands.fwd, drop, False, *ops)

    @staticmethod
    def backward(ctx, g):
        return _band_all(g.contiguous(), ctx.bwd, ctx.drop, True, *ctx.ops), None, None, None


def band_spmm(x: torch.Tensor, bands: BandPair, drop: Optional[DropSpec] = None
              ) -> torch.Tensor:
    """out = A @ x for the adjacency of ``bands.fwd`` (out[r] = Σ_{e: recv=r}
    x[send_e]); backward Aᵀ @ g through ``bands.bwd``. ``drop`` applies the
    same hash edge-drop in both directions."""
    return _BandSpmm.apply(x, bands, drop, _KERNELS)


def band_spmm_plain(x: torch.Tensor, bands: BandPair, drop: Optional[DropSpec] = None
                    ) -> torch.Tensor:
    """`band_spmm` on the plain versions of K3 and K1, on any device."""
    return _BandSpmm.apply(x, bands, drop, _PLAIN)


def band_sum_auto(x: torch.Tensor, bands: BandPair, drop: Optional[DropSpec] = None
                  ) -> torch.Tensor:
    """out[r] = Σ_{e: recv=r} x[send_e] over the graph's valid edges (self
    edges and multiplicity included): the gather-free twin of a gather and a
    segment sum. The GPU has no lanes to pad."""
    return band_spmm(x.contiguous(), bands, drop)


def band_cmax(x: torch.Tensor, t: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-channel GLOBAL upper bound of the scores t·(relu(x_j) + ε)
    (`_band_cmax`, `ops/band.py:637-642`): t·(max relu(x) + ε) over all N_pad
    rows for t > 0, else t·ε. relu commutes with the max, so the maximum is
    taken in x's dtype. The band route's node-factored softmax needs one
    shift for every receiver; GENConv's gather route shifts each receiver by
    its own maximum (`spmm_cuda.softmax_agg`)."""
    m_ub = torch.clamp_min(x.detach().amax(0).float(), 0.0) + eps
    return torch.where(t > 0, t * m_ub, t * eps)


def softmax_table(x: torch.Tensor, t0: torch.Tensor, eps: float):
    """The packed node table [e·m | e] of the node-factored softmax
    aggregation, in x's dtype, with m = relu(x) + ε, e = exp(t·m − cmax), and
    the per-channel global bound cmax (`band_cmax`)."""
    cmax = band_cmax(x, t0, eps)
    m = torch.relu(x.float()) + eps
    e = torch.exp(m * t0 - cmax)
    return torch.cat([e * m, e], 1).to(x.dtype), cmax


class _BandSoftmaxAgg(torch.autograd.Function):
    """Forward: one `_band_all` of the packed table, then num/den. Backward
    (`ops/band.py:689-713`), with q = g/den, M = relu(x) + ε and
    E = exp(t·M − cmax):

        softmax_sg: dx = relu'(x) ⊙ E ⊙ Aᵀq
        learn_t:    dx = relu'(x) ⊙ E ⊙ [(1 + t·M)·S₁ − t·S₂],
                    dt = Σ E⊙M⊙(M⊙S₁ − S₂),   [S₁|S₂] = Aᵀ[q | q⊙out]"""

    @staticmethod
    def forward(ctx, x, t, bands, eps, grad_weights, ops):
        c = x.shape[1]
        t0 = t.detach().float().reshape(-1)[:1]
        p, cmax = softmax_table(x, t0, eps)
        agg = _band_all(p, bands.fwd, None, False, *ops)
        num = agg[:, :c].float()
        den = agg[:, c:].float()
        pos = den > 0
        out = torch.where(pos, num / torch.where(pos, den, 1.0), 0.0).to(x.dtype)
        ctx.save_for_backward(x, t0, den.to(x.dtype), cmax, out if grad_weights else None)
        ctx.bwd, ctx.eps, ctx.grad_weights, ctx.ops, ctx.t_shape = (
            bands.bwd, eps, grad_weights, ops, t.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        x, t0, den, cmax, out = ctx.saved_tensors
        c = x.shape[1]
        den = den.float()
        pos = den > 0
        q = torch.where(pos, g.float() / torch.where(pos, den, 1.0), 0.0)
        m_node = torch.relu(x.float()) + ctx.eps
        e_node = torch.exp(m_node * t0 - cmax)
        qo = torch.cat([q, q * out.float()], 1) if ctx.grad_weights else q
        s_all = _band_all(qo.to(x.dtype), ctx.bwd, None, False, *ctx.ops).float()
        if ctx.grad_weights:
            s1, s2 = s_all[:, :c], s_all[:, c:]
            dm = e_node * ((1.0 + t0 * m_node) * s1 - t0 * s2)
            dt = (e_node * m_node * (m_node * s1 - s2)).sum().expand(ctx.t_shape)
        else:
            dm = e_node * s_all
            dt = torch.zeros(ctx.t_shape, device=x.device)
        dx = torch.where(x > 0, dm, 0.0).to(x.dtype)
        return dx, dt, None, None, None, None


def band_softmax_agg(x: torch.Tensor, bands: BandPair, t: torch.Tensor,
                     eps: float = 1e-7, grad_weights: bool = False) -> torch.Tensor:
    """GENConv softmax aggregation, gather-free (no edge embeddings):

        out[n] = Σ_{e: recv=n} softmax_e(t·m_e)·m_e,   m_e = relu(x[send_e]) + ε

    ``grad_weights`` False keeps the stop-gradient softmax weights
    (softmax_sg); True differentiates through them and ``t``."""
    return _BandSoftmaxAgg.apply(x.contiguous(), t, bands, eps, grad_weights, _KERNELS)


def band_softmax_agg_plain(x: torch.Tensor, bands: BandPair, t: torch.Tensor,
                           eps: float = 1e-7, grad_weights: bool = False) -> torch.Tensor:
    """`band_softmax_agg` on the plain versions of K3 and K1, on any device."""
    return _BandSoftmaxAgg.apply(x.contiguous(), t, bands, eps, grad_weights, _PLAIN)


# the call site's name in the JAX package; on the GPU there are no lanes to pad
band_softmax_agg_auto = band_softmax_agg


# ---------------------------------------------------------------------------
# GAT with sender-only scores
# ---------------------------------------------------------------------------

def band_gat_agg(feat_src: torch.Tensor, el: torch.Tensor, bands: BandPair,
                 neg_slope: float = 0.2, compute_dtype: Optional[torch.dtype] = None,
                 drop: Optional[DropSpec] = None):
    """Gather-free GAT aggregation for sender-only scores (`band_gat_agg`,
    `ops/band.py:732-777` of the JAX package): score_e = leaky_relu(el[send_e])
    is a node table, so with one global per-head shift cmax (no gradient)
    num and den are ONE band product of the packed [e·feat | e] table,
    e = exp(score − cmax). ``drop`` is the hash edge-drop, applied alike in
    the forward and its transpose.

    feat_src [N, H, D], el [N, H]; returns (num [N, H, D], den [N, H]) in
    float32, for the caller to divide. The table is padded with zero columns
    to a multiple of 8, which is exact and gives K3 and K1 their 4-wide loads
    (H·D + H is odd at RevGAT's widths)."""
    n, h, d = feat_src.shape
    score = torch.nn.functional.leaky_relu(el.float(), neg_slope)
    cmax = score.detach().amax(0)
    e = torch.exp(score - cmax)
    cd = compute_dtype or feat_src.dtype
    p = torch.cat([(e[:, :, None] * feat_src.float()).reshape(n, h * d), e], 1).to(cd)
    p = torch.nn.functional.pad(p, (0, (-p.shape[1]) % 8))
    agg = band_sum_auto(p, bands, drop)
    return (agg[:, :h * d].float().reshape(n, h, d), agg[:, h * d:h * d + h].float())


def band_gat_dense_agg(feat_src: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                       bands: BandPair, neg_slope: float = 0.2,
                       compute_dtype: Optional[torch.dtype] = None,
                       drop: Optional[DropSpec] = None,
                       self_score: Optional[torch.Tensor] = None,
                       self_feat: Optional[torch.Tensor] = None,
                       self_count: Optional[torch.Tensor] = None):
    """Gather-free GAT aggregation for destination scores
    (`band_gat_dense_agg`, `ops/band.py:780-811` of the JAX package):
    score_e = leaky_relu(el[send_e] + er[recv_e]) per head is not additively
    separable, so it is evaluated densely over every band structure with an
    exact shared per-receiver stabilizer (`ops/gat_dense.py`: K7 forward, K8
    and K9 backward, K1 for the leftover).

    Returns (num [N, H, D], den [N, H]) in float32; the caller divides.
    PyG-1.x self-loop semantics (`convs/sparse.GATConv`): pass
    ``self_score`` [N, H], ``self_feat`` [N, H, D] and ``self_count`` [N]
    (explicit self edges per node), so that the softmax runs over the
    neighbours and exactly one self term; not with ``drop``."""
    if self_score is not None and drop is not None:
        raise ValueError("the self-loop flavour and edge-drop are not composed (PyG's "
                         "GATConv has no edge-drop)")
    from .gat_dense import gat_dense_agg

    return gat_dense_agg(feat_src, el, er, self_score, self_feat, self_count, bands, drop,
                         neg_slope, compute_dtype)


# ---------------------------------------------------------------------------
# band extreme (max/min): the masked window reduce
# ---------------------------------------------------------------------------

# bytes of the [blocks, BN, W, C] intermediate of one step of the window
# reduce, which walks the receiver blocks in steps to stay under it
_EXTREME_STEP_BYTES = 1 << 28


def _window_extreme(x: torch.Tensor, band: Band, kind: str) -> torch.Tensor:
    """Per receiver, the extreme of x over its window edges: each 128-row
    block's window rows masked by count > 0 (`_window_extreme`,
    `ops/band.py:855-873` of the JAX package); ±inf where a row has none."""
    n_pad, c = x.shape
    w = band.window
    nb = n_pad // BN
    fill = torch.tensor(float("-inf") if kind == "max" else float("inf"), dtype=x.dtype,
                        device=x.device)
    reduce = torch.amax if kind == "max" else torch.amin
    mask = band.a.reshape(nb, BN, w) > 0
    cols = torch.arange(w, device=x.device)
    step = max(1, _EXTREME_STEP_BYTES // (BN * w * max(c, 1) * x.element_size()))
    out = []
    for b0 in range(0, nb, step):
        idx = torch.clamp(band.w_lo[b0:b0 + step].long()[:, None] + cols, max=n_pad - 1)
        win = x.index_select(0, idx.reshape(-1)).reshape(-1, 1, w, c)
        out.append(reduce(torch.where(mask[b0:b0 + step, :, :, None], win, fill), dim=2))
    return torch.cat(out).reshape(n_pad, c)


def _band_extreme_fwd(x: torch.Tensor, band: Band, kind: str) -> torch.Tensor:
    """The window extreme, combined with the leftover's segment extreme
    (its sentinel rows add ±inf, the identity), then 0 where a receiver has
    no edge (torch_scatter's empty-segment value)."""
    n_pad, c = x.shape
    out = _window_extreme(x, band, kind)
    if band.n_lo:
        fill = float("-inf") if kind == "max" else float("inf")
        xg = x.index_select(0, torch.clamp(band.lo_src.long(), max=n_pad - 1))
        vals = torch.where((band.lo_dst >= n_pad)[:, None],
                           torch.tensor(fill, dtype=x.dtype, device=x.device), xg)
        ids = torch.clamp(band.lo_dst.long(), max=n_pad - 1)[:, None].expand(-1, c)
        lo = torch.full((n_pad, c), fill, dtype=x.dtype, device=x.device).scatter_reduce(
            0, ids, vals, "amax" if kind == "max" else "amin", include_self=True)
        out = torch.maximum(out, lo) if kind == "max" else torch.minimum(out, lo)
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


class _BandExtreme(torch.autograd.Function):
    """Forward: `_band_extreme_fwd` on the forward band. Backward: the
    tie-splitting gather of the segment max/min (`_band_extreme_bwd`,
    `ops/band.py:922-939`): each edge whose sender's value equals its
    receiver's extreme takes the receiver's cotangent divided by the number
    of such edges, summed per sender."""

    @staticmethod
    def forward(ctx, x, band, senders, receivers, edge_mask, kind):
        out = _band_extreme_fwd(x, band, kind)
        ctx.save_for_backward(x, out, senders, receivers, edge_mask)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, senders, receivers, edge_mask = ctx.saved_tensors
        n_pad = x.shape[0]
        ids = torch.clamp(receivers.long(), max=n_pad - 1)
        sid = torch.clamp(senders.long(), max=n_pad - 1)
        elig = (x.index_select(0, sid) == out.index_select(0, ids)) & edge_mask[:, None]
        cnt = torch.zeros(out.shape, dtype=torch.float32, device=x.device).index_add_(
            0, ids, elig.float())
        cnt_e = torch.clamp_min(cnt, 1.0).index_select(0, ids)
        dd = torch.where(elig, g.float().index_select(0, ids) / cnt_e, 0.0)
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device).index_add_(0, sid, dd)
        return dx.to(x.dtype), None, None, None, None, None


def band_extreme(x: torch.Tensor, bands: BandPair, senders: torch.Tensor,
                 receivers: torch.Tensor, edge_mask: torch.Tensor,
                 kind: str = "max") -> torch.Tensor:
    """Gather-free segment max/min of the node table ``x`` over the graph's
    edges: out[r] = extreme_{e: recv=r} x[send_e], 0 for a receiver with no
    edge (`band_extreme`, `ops/band.py:892-910` of the JAX package). The
    forward reads windows instead of edge rows; the backward reads the
    graph's (sentinel-padded) edge arrays. Needs a hub-free band
    (`band_extreme_ok`)."""
    return _BandExtreme.apply(x, bands.fwd, senders, receivers, edge_mask, kind)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

# aggregators with a node-factored band form (max/min take `band_extreme`
# under its own gate)
BAND_SOFTMAX_AGGRS = ("softmax", "softmax_sg", "softmax_sum")
BAND_SUM_AGGRS = ("add", "sum", "mean", "power", "power_sum")


# the least share of edges a band must carry gather-free to take the route
# (the JAX package's default, tuned on the TPU)
MIN_COVERAGE = 0.5


def band_sum_ok(g) -> bool:
    """A band is attached and carries at least `MIN_COVERAGE` of the edges
    gather-free. The JAX package also requires a TPU; the port runs the band
    route wherever a band is attached."""
    band = getattr(g, "band", None)
    return band is not None and band.fwd.coverage >= MIN_COVERAGE


def band_ok(g, aggr: str) -> bool:
    """Route GENConv's aggregation through the band: a band-servable
    aggregator and `band_sum_ok`."""
    return aggr in BAND_SOFTMAX_AGGRS + BAND_SUM_AGGRS and band_sum_ok(g)


def band_gat_dense_ok(g, min_coverage: float = MIN_COVERAGE) -> bool:
    """Gate of the dense destination-score GAT route (`band_gat_dense_ok`,
    `ops/band.py:814-828`): a band carrying at least ``min_coverage`` of the
    edges; hub structures are allowed. No platform check, as `band_sum_ok`."""
    band = getattr(g, "band", None)
    return band is not None and band.fwd.coverage >= min_coverage


# the widest window the max/min route takes (the JAX package's, measured on
# the TPU: the masked reduce pays a compare per window element)
MAX_EXTREME_WINDOW = 256


def band_extreme_ok(g, min_coverage: float = 0.98) -> bool:
    """Gate of the max/min band route (`band_extreme_ok`, `ops/band.py:
    945-964` of the JAX package): a band with no hub structures (the window
    reduce serves the window band and the leftover only), a window of at
    most `MAX_EXTREME_WINDOW` and coverage of at least ``min_coverage``. A
    refused band is counted in `route_misses.FASTPATH_MISSES`. No platform
    check, as `band_sum_ok`."""
    band = getattr(g, "band", None)
    if band is None:
        return False
    f = band.fwd
    cuda = f.a.is_cuda
    if f.hub_ids is not None or f.hub_row_ids is not None:
        return miss("band_extreme", "hub structures present (max/min window reduce "
                                    "serves the pure window band only)", warn=cuda)
    if f.window > MAX_EXTREME_WINDOW:
        return miss("band_extreme", f"window {f.window} > {MAX_EXTREME_WINDOW}", warn=cuda)
    if f.coverage < min_coverage:
        return miss("band_extreme", f"band coverage {f.coverage:.2f} < {min_coverage}",
                    warn=cuda)
    return True


def band_extreme_route(g, x: torch.Tensor) -> bool:
    """Whether MRConv's and GENConv's max/min take `band_extreme`: on the
    CPU where `band_extreme_ok` holds, as the JAX package routes them; never
    on the card, where the window reduce, which reads N·W rows where the
    gather reads E, lost to the gather + segment max it replaces (2.4–2.8×
    forward and backward on a hub-free graph at window 256, NVIDIA H100
    80GB HBM3; `chip_smoke.py` phase 53 times both). Neither route has a
    kernel of its own: the choice is no miss."""
    return not x.is_cuda and band_extreme_ok(g)
