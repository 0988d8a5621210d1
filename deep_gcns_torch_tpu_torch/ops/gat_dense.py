"""Dense-window GAT aggregation for destination scores (counterpart of
`deep_gcns_torch_tpu/ops/gat_dense.py:58-847`).

The score s_e = leaky_relu(el[send_e] + er[recv_e]) (per head) is not a
node table, so the sum factorisation of `band.band_gat_agg` does not apply.
This module evaluates

    num[r] = Σ_e c_e · exp(s_e − M_r) · feat[send_e]
    den[r] = Σ_e c_e · exp(s_e − M_r)               (the caller divides)

over every structure of the band (window, hub columns, hub rows, leftover,
and the optional analytic self term of PyG's GATConv), with the EXACT
per-receiver stabilizer M_r = max_e s_e taken over all of them (no
gradient). c_e is the edge count of a band position.

The window band and the hub columns of a band with at most `GAT_MAX_HUBS`
of them are three CUDA kernels (`csrc/win_fused.cu`, `csrc/win_der.cu`,
`csrc/win_dsend.cu`, sharing `csrc/gat_dense.cuh`):

* K7 `win_fused` (replaces `_k_fused`, `ops/gat_dense.py:1274` · `:1380`):
  completes M = max(window, hub columns, ``m_other``) and the num/den of
  those positions against it;
* K8 `win_der` (`_k_der`, `:966` · `:1208`): the receiver side of the
  backward, d_er[r] = Σ t over the forward band;
* K9 `win_dsend` (`_k_dsend`, `:1048` · `:1250`): the sender side over the
  transpose band, d_el[s] = Σ t and d_feat[s] = Σ E·g_num[r],

with E = c·exp(min(s − M, 50)), q = ⟨feat[s], g_num[r]⟩_h + g_den[r] and
t = E·q·lrelu′(z). Each has a plain PyTorch version here that walks the same
non-zero positions as a list of edges; a CPU tensor takes it, a CUDA tensor
the kernel. The hub rows, the hub columns of a band with more hubs, the
leftover (summed through K1, `csr_seg_sum`) and the self term stay PyTorch,
as they stay XLA in the JAX package. The hash edge-drop of a hub pass is one
keep plane per structure and conv call, shared by the passes that read it.

The TPU's transposed count tiles, its 128-lane containers and padded heads
are layout, not contract: the kernels read the row-major ``a`` and
``a_hub`` (bf16 on the card). K8 gives a warp to each (row, head); K7
gives a warp to each receiver row and all its heads, K9 to each sender row
of the transpose band and all its heads, each with a list of the row's kept
positions in shared memory (`k7_list_size` and `k9_list_size` entries; a
longer row is done in list-sized chunks inside the kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..nn.core import mm_f32
from ._build import library
from .band import BN, Band, BandPair, DropSpec, _drop_planes
from .spmm_cuda import (_SUFFIX, _check_index, _raise_on, _require, _vec, csr_seg_sum,
                        csr_seg_sum_plain)

NEG = -1e30          # "no edge" score (finite: NEG − NEG == 0, no NaNs)
CAP = 50.0           # shift cap: exp(≤ 50) is finite even for masked positions
GAT_MAX_HUBS = 2048  # hub columns a kernel takes; more go through the PyTorch passes
# elements of one float32 [rows, columns, heads] intermediate of a hub pass
HUB_BUDGET = 1 << 26
# edges per block of the plain versions' [E, H, D] float32 intermediates
_EDGE_BLOCK = 1 << 18
# K7: shared memory a warp gives the list of its row's kept positions (ids,
# counts and one weight a head per entry, and M and den per head), and the
# most entries a list takes
K7_LIST_BYTES = 6144
K7_MAX_LIST = 256
# K7's walk forms: `nch` groups of 32·vec columns a lane, by vec
_K7_FORMS = {4: (1, 2, 3, 6), 1: (8,)}
# K9: shared memory a warp gives its list (ids, counts, and round(E) and
# E·lrelu′ a head per entry, beside d_el per head), the most entries a list
# takes, and its walk forms (the widest walks a wider row in column chunks:
# its two float32 sums a column cost twice K7's registers)
K9_LIST_BYTES = 6144
K9_MAX_LIST = 256
_K9_FORMS = {4: (1, 2, 3), 1: (8,)}


def _lrelu(z: torch.Tensor, ns: float) -> torch.Tensor:
    return torch.where(z >= 0, z, z * ns)


def _dlrelu(z: torch.Tensor, ns: float) -> torch.Tensor:
    return torch.where(z >= 0, 1.0, ns)


def _weight(cnt: torch.Tensor, s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """c·exp(min(s − M, CAP)), the JAX kernels' order of operations."""
    return cnt * torch.exp(torch.clamp_max(s - m, CAP))


def _hub_in_kernel(band: Band) -> bool:
    return band.hub_ids is not None and band.hub_ids.shape[0] <= GAT_MAX_HUBS


def _blocks(n: int, step: int):
    return [(a, min(a + step, n)) for a in range(0, n, step)]


# ---------------------------------------------------------------------------
# the plain versions of K7–K9: the kernels' positions as a list of edges
# ---------------------------------------------------------------------------

def _entries(band: Band, drop: Optional[DropSpec], swap: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row, node id, count) of every valid position of the window band and,
    when the kernel takes them, the hub columns: a non-zero count whose edge
    the hash keeps. ``swap``: the band is a transpose band (rows are
    senders, ids receivers)."""
    rows, cols = torch.nonzero(band.a > 0, as_tuple=True)
    cnt = band.a[rows, cols].float()
    ids = band.w_lo.long()[rows // BN] + cols
    if _hub_in_kernel(band):
        rh, k = torch.nonzero(band.a_hub > 0, as_tuple=True)
        rows = torch.cat([rows, rh])
        ids = torch.cat([ids, band.hub_ids.long()[k]])
        cnt = torch.cat([cnt, band.a_hub[rh, k].float()])
    if drop is not None:
        keep = _drop_planes(rows, ids, drop, swap)
        rows, ids, cnt = rows[keep], ids[keep], cnt[keep]
    return rows, ids, cnt[:, None]


def _dots(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor, ib: torch.Tensor, h: int
          ) -> torch.Tensor:
    """[E, H] per-head dots ⟨a[ia[e]], b[ib[e]]⟩ in float32 (bf16 products
    are exact there), in blocks of edges."""
    out = torch.empty((ia.shape[0], h), dtype=torch.float32, device=a.device)
    for lo, hi in _blocks(ia.shape[0], _EDGE_BLOCK):
        pa = a.index_select(0, ia[lo:hi]).float().reshape(hi - lo, h, -1)
        pb = b.index_select(0, ib[lo:hi]).float().reshape(hi - lo, h, -1)
        out[lo:hi] = (pa * pb).sum(-1)
    return out


def _weighted_rows(rows: torch.Tensor, w: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                   n: int, h: int) -> torch.Tensor:
    """out[r] = Σ_{e: rows[e]=r} round(w[e]) ⊙ x[ids[e]] per head, float32,
    with w rounded to x's dtype (the TPU kernels' `e.astype(cdk)`)."""
    hd = x.shape[1]
    out = torch.zeros((n, hd), dtype=torch.float32, device=x.device)
    wr = w.to(x.dtype).float()
    for lo, hi in _blocks(rows.shape[0], _EDGE_BLOCK):
        xs = x.index_select(0, ids[lo:hi]).float().reshape(hi - lo, h, -1)
        out.index_add_(0, rows[lo:hi], (wr[lo:hi, :, None] * xs).reshape(hi - lo, hd))
    return out


def win_fused_plain(band: Band, el: torch.Tensor, er: torch.Tensor, m_other: torch.Tensor,
                    feat: torch.Tensor, neg_slope: float, drop: Optional[DropSpec] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's function: per receiver r and head, over the window band and the
    in-kernel hub columns, M = max(max lrelu(el[s] + er[r]), m_other[r]),
    E = c·exp(min(s − M, 50)), den = Σ E and num = Σ round(E)·feat[s].
    el, er, m_other float32 [N, H], feat [N, H·D] in the compute dtype;
    returns (num [N, H·D], den [N, H], M [N, H]), all float32."""
    n, h = er.shape
    rows, ids, cnt = _entries(band, drop, False)
    s = _lrelu(el[ids] + er[rows], neg_slope)
    m = m_other.scatter_reduce(0, rows[:, None].expand(-1, h), s, "amax")
    e = _weight(cnt, s, m[rows])
    den = torch.zeros((n, h), dtype=torch.float32, device=er.device).index_add_(0, rows, e)
    return _weighted_rows(rows, e, feat, ids, n, h), den, m


def win_der_plain(band: Band, el: torch.Tensor, er: torch.Tensor, m: torch.Tensor,
                  feat: torch.Tensor, gnum: torch.Tensor, gden: torch.Tensor,
                  neg_slope: float, drop: Optional[DropSpec] = None) -> torch.Tensor:
    """K8's function: d_er[r] = Σ_s E·(⟨feat[s], gnum[r]⟩_h + gden[r])·
    lrelu′(z) over the forward band's window and in-kernel hub columns.
    gnum [N, H·D] in feat's dtype, gden and the result float32 [N, H]."""
    n, h = er.shape
    rows, ids, cnt = _entries(band, drop, False)
    z = el[ids] + er[rows]
    e = _weight(cnt, _lrelu(z, neg_slope), m[rows])
    q = _dots(gnum, rows, feat, ids, h) + gden[rows]
    t = e * q * _dlrelu(z, neg_slope)
    return torch.zeros((n, h), dtype=torch.float32, device=er.device).index_add_(0, rows, t)


def win_dsend_plain(band_bwd: Band, el: torch.Tensor, er: torch.Tensor, m: torch.Tensor,
                    feat: torch.Tensor, gnum: torch.Tensor, gden: torch.Tensor,
                    neg_slope: float, drop: Optional[DropSpec] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's function over the TRANSPOSE band (rows are senders s, positions
    receivers r): d_el[s] = Σ_r t and d_feat[s] = Σ_r round(E)·gnum[r];
    returns (d_el [N, H], d_feat [N, H·D]), float32."""
    n, h = el.shape
    rows, ids, cnt = _entries(band_bwd, drop, True)
    z = el[rows] + er[ids]
    e = _weight(cnt, _lrelu(z, neg_slope), m[ids])
    q = _dots(feat, rows, gnum, ids, h) + gden[ids]
    t = e * q * _dlrelu(z, neg_slope)
    d_el = torch.zeros((n, h), dtype=torch.float32, device=el.device).index_add_(0, rows, t)
    return d_el, _weighted_rows(rows, e, gnum, ids, n, h)


# ---------------------------------------------------------------------------
# K7–K9 on the card
# ---------------------------------------------------------------------------

def _check_tables(n: int, h: int, **tables: torch.Tensor):
    for name, t in tables.items():
        _require(t.device.type == "cuda" and t.dtype == torch.float32 and t.shape == (n, h)
                 and t.is_contiguous(),
                 f"{name} must be a contiguous float32 [{n}, {h}] CUDA tensor, got "
                 f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _head_layout(h: int, d: int, vec: int) -> Tuple[int]:
    """(nch,) of K8, which walks one head's D columns: groups of 32·vec
    columns a lane."""
    _require(d <= 256, f"a head of {d} columns is wider than K8 takes (256)")
    return ((1 if d <= 128 else 2) if vec == 4 else 8,)


def _launch(name: str, band: Band, feat: torch.Tensor, rows: Tuple[torch.Tensor, ...],
            tables: Tuple[torch.Tensor, ...], outs: Tuple[torch.Tensor, ...], h: int,
            neg_slope: float, drop: Optional[DropSpec], layout=_head_layout):
    """Checks shared by K7–K9 and the launch of ``dgc_<name>_<dtype>``.
    ``rows``: the [N, H·D] tables in feat's dtype (feat first); ``tables``
    the float32 [N, H] ones; ``outs`` the float32 outputs; ``layout(h, d,
    vec)`` the kernel's walk form (K7: `k7_layout`, K9: `k9_layout`)."""
    dev = feat.device
    n, hd = feat.shape
    for t in rows:
        _require(t.device == dev and t.dtype == feat.dtype and t.shape == (n, hd)
                 and t.is_contiguous(),
                 f"the [N, H·D] tables must be contiguous {feat.dtype} [{n}, {hd}] on {dev}")
    _require(feat.dtype in _SUFFIX, f"feat must be float32 or bfloat16, got {feat.dtype}")
    _require(h > 0 and hd % h == 0, f"{hd} columns do not split into {h} heads")
    a, w = band.a, band.window
    _require(n % BN == 0 and a.shape == (n, w) and a.dtype == torch.int8 and a.device == dev
             and a.is_contiguous(), f"band.a is {tuple(a.shape)} {a.dtype}, expected "
                                    f"contiguous int8 ({n}, {w}) on {dev}")
    _require(w % 8 == 0 and a.data_ptr() % 8 == 0,
             "the window must be a multiple of 8 and A 8-byte aligned")
    _check_index("band.w_lo", band.w_lo, dev)
    _require(band.w_lo.shape[0] == n // BN, "band.w_lo must have N_pad/128 entries")
    a_hub = hub_ids = None
    n_hub = 0
    if _hub_in_kernel(band):
        a_hub = band.a_hub.to(torch.bfloat16).contiguous()
        hub_ids = band.hub_ids
        n_hub = hub_ids.shape[0]
        _check_index("band.hub_ids", hub_ids, dev)
        _require(a_hub.shape == (n, n_hub) and n_hub % 8 == 0 and a_hub.data_ptr() % 16 == 0,
                 f"band.a_hub must be [{n}, H] with H a multiple of 8, got "
                 f"{tuple(a_hub.shape)}")
    d = hd // h
    vec = _vec(d, *rows, *(o for o in outs if o.shape[1] == hd)) if hd % 4 == 0 else 1
    form = layout(h, d, vec)
    k0, k1, thresh = (0, 0, -1) if drop is None else (
        int(drop.k0), int(drop.k1), int(drop.thresh))
    fn = getattr(library(name), f"dgc_{name}_{_SUFFIX[feat.dtype]}")
    rc = fn(a.data_ptr(), band.w_lo.data_ptr(), None if a_hub is None else a_hub.data_ptr(),
            None if hub_ids is None else hub_ids.data_ptr(), *(t.data_ptr() for t in tables),
            *(t.data_ptr() for t in rows), *(o.data_ptr() for o in outs), n, w, n_hub, h,
            d, float(neg_slope), k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF, thresh, vec, *form,
            torch.cuda.current_stream(dev).cuda_stream)
    return rc


def k7_list_size(h: int) -> int:
    """Entries of the list in which a warp of K7 keeps its row's kept
    positions: as many multiples of 32 as `K7_LIST_BYTES` holds at 4 bytes
    for the id, the count and each head's weight (beside M and den per head),
    at least 32 and at most `K7_MAX_LIST`. A row with more kept positions is
    done in chunks of this size inside the kernel."""
    fit = (K7_LIST_BYTES - 8 * h) // (4 * (2 + h)) // 32 * 32
    return max(32, min(K7_MAX_LIST, fit))


def k7_layout(h: int, d: int, vec: int) -> Tuple[int, int]:
    """(nch, list size) of K7 for H heads of D columns: nch groups of 32·vec
    columns a lane's walk, the fewest of K7's forms that cover H·D (the
    widest form walks a wider row in column chunks). The kernel refuses a
    block whose hub ids and 8 lists exceed the card's shared memory."""
    need = -(-(h * d) // (32 * vec))
    forms = _K7_FORMS[vec]
    return next((f for f in forms if f >= need), forms[-1]), k7_list_size(h)


def k9_list_size(h: int) -> int:
    """Entries of the list in which a warp of K9 keeps its sender row's kept
    positions: as many multiples of 32 as `K9_LIST_BYTES` holds at 4 bytes
    for the id, the count and two values a head (beside d_el per head), at
    least 32 and at most `K9_MAX_LIST`. A row with more kept positions is
    done in chunks of this size inside the kernel."""
    fit = (K9_LIST_BYTES - 4 * h) // (4 * (2 + 2 * h)) // 32 * 32
    return max(32, min(K9_MAX_LIST, fit))


def k9_layout(h: int, d: int, vec: int) -> Tuple[int, int]:
    """(nch, list size) of K9 for H heads of D columns: nch groups of 32·vec
    columns a lane's walk, the fewest of K9's forms that cover H·D, or the
    widest, which walks a wider row (3 x 256) in column chunks."""
    need = -(-(h * d) // (32 * vec))
    forms = _K9_FORMS[vec]
    return next((f for f in forms if f >= need), forms[-1]), k9_list_size(h)


def win_fused(band: Band, el: torch.Tensor, er: torch.Tensor, m_other: torch.Tensor,
              feat: torch.Tensor, neg_slope: float, drop: Optional[DropSpec] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 (`csrc/win_fused.cu`) on a CUDA tensor; the plain version on
    a CPU one."""
    if feat.device.type == "cpu":
        return win_fused_plain(band, el, er, m_other, feat, neg_slope, drop)
    n, hd = feat.shape
    h = er.shape[1]
    _check_tables(n, h, el=el, er=er, m_other=m_other)
    num = torch.empty((n, hd), dtype=torch.float32, device=feat.device)
    den = torch.empty((n, h), dtype=torch.float32, device=feat.device)
    m = torch.empty((n, h), dtype=torch.float32, device=feat.device)
    rc = _launch("win_fused", band, feat, (feat,), (el, er, m_other), (num, den, m), h,
                 neg_slope, drop, k7_layout)
    win_fused.launches += 1
    _raise_on(rc, "K7 win_fused")
    return num, den, m


win_fused.launches = 0


def win_der(band: Band, el: torch.Tensor, er: torch.Tensor, m: torch.Tensor,
            feat: torch.Tensor, gnum: torch.Tensor, gden: torch.Tensor, neg_slope: float,
            drop: Optional[DropSpec] = None) -> torch.Tensor:
    """K8 (`csrc/win_der.cu`) on a CUDA tensor; the plain version on a
    CPU one."""
    if feat.device.type == "cpu":
        return win_der_plain(band, el, er, m, feat, gnum, gden, neg_slope, drop)
    n = feat.shape[0]
    h = er.shape[1]
    _check_tables(n, h, el=el, er=er, m=m, gden=gden)
    d_er = torch.empty((n, h), dtype=torch.float32, device=feat.device)
    rc = _launch("win_der", band, feat, (feat, gnum), (el, er, m, gden), (d_er,), h,
                 neg_slope, drop)
    win_der.launches += 1
    _raise_on(rc, "K8 win_der")
    return d_er


win_der.launches = 0


def win_dsend(band_bwd: Band, el: torch.Tensor, er: torch.Tensor, m: torch.Tensor,
              feat: torch.Tensor, gnum: torch.Tensor, gden: torch.Tensor, neg_slope: float,
              drop: Optional[DropSpec] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 (`csrc/win_dsend.cu`) on a CUDA tensor; the plain version on
    a CPU one. ``band_bwd`` is the transpose band."""
    if feat.device.type == "cpu":
        return win_dsend_plain(band_bwd, el, er, m, feat, gnum, gden, neg_slope, drop)
    n, hd = feat.shape
    h = el.shape[1]
    _check_tables(n, h, el=el, er=er, m=m, gden=gden)
    d_el = torch.empty((n, h), dtype=torch.float32, device=feat.device)
    d_feat = torch.empty((n, hd), dtype=torch.float32, device=feat.device)
    rc = _launch("win_dsend", band_bwd, feat, (feat, gnum), (el, er, m, gden),
                 (d_el, d_feat), h, neg_slope, drop, k9_layout)
    win_dsend.launches += 1
    _raise_on(rc, "K9 win_dsend")
    return d_el, d_feat


win_dsend.launches = 0


# ---------------------------------------------------------------------------
# the PyTorch passes: hub rows, out-of-kernel hub columns, leftover
# ---------------------------------------------------------------------------

class Keeps:
    """The valid masks of one band's PyTorch passes for one conv call, each
    built once (count > 0, and kept by the hash when dropping): ``rows``
    [R, N] for the hub rows, ``cols`` [N, H] for hub columns the kernel does
    not take, ``lo`` [E_lo] for the leftover (None: all valid)."""

    def __init__(self, band: Band, drop: Optional[DropSpec], swap: bool):
        n = band.a.shape[0]
        dev = band.a.device
        ar = torch.arange(n, device=dev)
        self.rows = self.cols = self.lo = None
        if band.hub_row_ids is not None:
            self.rows = band.a_row > 0
            if drop is not None:
                self.rows &= _drop_planes(band.hub_row_ids.long()[:, None], ar[None, :], drop,
                                          swap)
        if band.hub_ids is not None and not _hub_in_kernel(band):
            self.cols = band.a_hub > 0
            if drop is not None:
                self.cols &= _drop_planes(ar[:, None], band.hub_ids.long()[None, :], drop,
                                          swap)
        if band.n_lo and drop is not None:
            nl = band.n_lo
            self.lo = _drop_planes(band.lo_dst[:nl].long(), band.lo_src[:nl].long(), drop,
                                   swap)


def _head_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[H, P, Q] per-head products a[h] @ b[h] of [H, P, K] and [H, K, Q]
    tables in the compute dtype, accumulated and returned in float32 (bf16
    products are exact there; on the card a bf16 tensor-core product)."""
    return torch.stack([mm_f32(a[k], b[k]) for k in range(a.shape[0])])


# The hub-row passes run heads first ([H, R, senders]) so that their
# elementwise work is contiguous; the JAX package's order of additions and
# roundings is kept.

def _hubrow_max(band, elf, erf, ns, valid):
    """[R, H] maximum over the hub receivers' complete rows."""
    er_rows = erf[band.hub_row_ids.long()].t()
    n, h = elf.shape
    R = er_rows.shape[1]
    m = torch.full((h, R), NEG, dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (R * h))):
        s = _lrelu(er_rows[:, :, None] + elf[a:b].t()[:, None, :], ns)
        m = torch.maximum(m, torch.where(valid[None, :, a:b], s, NEG).amax(2))
    return m.t()


def _hubrow_e(band, elf, erf, m_rows, ns, valid, a, b):
    """(E, z) [H, R, b − a] of the hub rows against senders a..b."""
    z = erf[band.hub_row_ids.long()].t()[:, :, None] + elf[a:b].t()[:, None, :]
    e = torch.where(valid[None, :, a:b],
                    _weight(band.a_row[None, :, a:b].float(), _lrelu(z, ns),
                            m_rows.t()[:, :, None]), 0.0)
    return e, z


def _hubrow_sum(band, elf, erf, m_rows, featc3, ns, valid, cd):
    """(num [R, H, D], den [R, H]) of the hub rows."""
    R = band.hub_row_ids.shape[0]
    n, h, d = featc3.shape
    num = torch.zeros((h, R, d), dtype=torch.float32, device=elf.device)
    den = torch.zeros((h, R), dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (R * h))):
        e, _ = _hubrow_e(band, elf, erf, m_rows, ns, valid, a, b)
        num += _head_mm(e.to(cd), featc3[a:b].transpose(0, 1))
        den += e.sum(2)
    return num.transpose(0, 1), den.t()


def _hubrow_der(band, elf, erf, m_rows, featc3, gnum_rows, gden_rows, ns, valid):
    """[R, H] d_er of the hub rows; gnum_rows in the compute dtype."""
    R = band.hub_row_ids.shape[0]
    n, h, _ = featc3.shape
    der = torch.zeros((h, R), dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (R * h))):
        e, z = _hubrow_e(band, elf, erf, m_rows, ns, valid, a, b)
        q = (_head_mm(gnum_rows.transpose(0, 1), featc3[a:b].permute(1, 2, 0))
             + gden_rows.t()[:, :, None])
        der += (e * q * _dlrelu(z, ns)).sum(2)
    return der.t()


def _hubrow_dsend(band_bwd, elf, erf, m, featc3, gnum3, gden, ns, valid, cd):
    """(d_el [R, H], d_feat [R, H, D]) of the transpose band's hub rows (the
    top out-degree senders' complete rows over receivers)."""
    ids = band_bwd.hub_row_ids.long()
    R = ids.shape[0]
    n, h, d = featc3.shape
    el_rows = elf[ids].t()
    f_rows = featc3[ids].transpose(0, 1)
    d_el = torch.zeros((h, R), dtype=torch.float32, device=elf.device)
    d_f = torch.zeros((h, R, d), dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (R * h))):
        z = el_rows[:, :, None] + erf[a:b].t()[:, None, :]
        e = torch.where(valid[None, :, a:b],
                        _weight(band_bwd.a_row[None, :, a:b].float(), _lrelu(z, ns),
                                m[a:b].t()[:, None, :]), 0.0)
        gn = gnum3[a:b].transpose(0, 1)
        q = _head_mm(f_rows, gn.transpose(1, 2)) + gden[a:b].t()[:, None, :]
        d_el += (e * q * _dlrelu(z, ns)).sum(2)
        d_f += _head_mm(e.to(cd), gn)
    return d_el.t(), d_f.transpose(0, 1)


def _hubcol_e(band, el_hub, erf, m, ns, valid, a, b):
    """(E, z) [b − a, H_hub, H] of receivers a..b against the hub columns."""
    z = erf[a:b, None, :] + el_hub[None]
    e = torch.where(valid[a:b, :, None],
                    _weight(band.a_hub[a:b, :, None].float(), _lrelu(z, ns), m[a:b, None, :]),
                    0.0)
    return e, z


def _hubcol_max(band, elf, erf, ns, valid):
    n, h = erf.shape
    el_hub = elf[band.hub_ids.long()]
    m = torch.empty((n, h), dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (el_hub.shape[0] * h))):
        s = _lrelu(erf[a:b, None, :] + el_hub[None], ns)
        m[a:b] = torch.where(valid[a:b, :, None], s, NEG).amax(1)
    return m


def _hubcol_sum(band, elf, erf, m, featc3, ns, valid, cd):
    n, h, d = featc3.shape
    ids = band.hub_ids.long()
    el_hub, f_hub = elf[ids], featc3[ids].float()
    num = torch.empty((n, h, d), dtype=torch.float32, device=elf.device)
    den = torch.empty((n, h), dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (ids.shape[0] * h))):
        e, _ = _hubcol_e(band, el_hub, erf, m, ns, valid, a, b)
        den[a:b] = e.sum(1)
        num[a:b] = torch.einsum("cHh,Hhd->chd", e.to(cd).float(), f_hub)
    return num, den


def _hubcol_der(band, elf, erf, m, featc3, gnum3, gden, ns, valid):
    n, h, _ = featc3.shape
    ids = band.hub_ids.long()
    el_hub, f_hub = elf[ids], featc3[ids].float()
    der = torch.empty((n, h), dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (ids.shape[0] * h))):
        e, z = _hubcol_e(band, el_hub, erf, m, ns, valid, a, b)
        q = torch.einsum("chd,Hhd->cHh", gnum3[a:b].float(), f_hub) + gden[a:b, None, :]
        der[a:b] = (e * q * _dlrelu(z, ns)).sum(1)
    return der


def _hubcol_dsend(band_bwd, elf, erf, m, featc3, gnum3, gden, ns, valid, cd):
    """d_el/d_feat over the transpose band's hub columns (the top in-degree
    receivers); rows are senders."""
    n, h, d = featc3.shape
    ids = band_bwd.hub_ids.long()
    er_hub, m_hub, gd_hub = erf[ids], m[ids], gden[ids]
    gn_hub = gnum3[ids].float()
    d_el = torch.empty((n, h), dtype=torch.float32, device=elf.device)
    d_f = torch.empty((n, h, d), dtype=torch.float32, device=elf.device)
    for a, b in _blocks(n, max(1, HUB_BUDGET // (ids.shape[0] * h))):
        z = elf[a:b, None, :] + er_hub[None]
        e = torch.where(valid[a:b, :, None],
                        _weight(band_bwd.a_hub[a:b, :, None].float(), _lrelu(z, ns),
                                m_hub[None]), 0.0)
        q = torch.einsum("chd,Hhd->cHh", featc3[a:b].float(), gn_hub) + gd_hub[None]
        d_el[a:b] = (e * q * _dlrelu(z, ns)).sum(1)
        d_f[a:b] = torch.einsum("cHh,Hhd->chd", e.to(cd).float(), gn_hub)
    return d_el, d_f


def _lo_edges(band: Band, swap: bool):
    """(sender ids, receiver ids) of the leftover's n_lo edges; a transpose
    band's lo_src are receivers."""
    nl = band.n_lo
    src, dst = band.lo_src[:nl].long(), band.lo_dst[:nl].long()
    return (dst, src) if swap else (src, dst)


def _lo_e(band, elf, erf, m, ns, keep, swap):
    s_ids, r_ids = _lo_edges(band, swap)
    z = elf[s_ids] + erf[r_ids]
    e = torch.exp(torch.clamp_max(_lrelu(z, ns) - m[r_ids], CAP))
    if keep is not None:
        e = torch.where(keep[:, None], e, 0.0)
    return e, z, s_ids, r_ids


def _pad8(x: torch.Tensor) -> torch.Tensor:
    """Zero columns up to a multiple of 8 (exact; K1's 4-wide loads)."""
    return torch.nn.functional.pad(x, (0, (-x.shape[1]) % 8)).contiguous()


def _lo_max(band, elf, erf, ns, keep):
    s_ids, r_ids = _lo_edges(band, False)
    s = _lrelu(elf[s_ids] + erf[r_ids], ns)
    if keep is not None:
        s = torch.where(keep[:, None], s, NEG)
    out = torch.full_like(erf, NEG)
    return out.scatter_reduce_(0, r_ids[:, None].expand(-1, erf.shape[1]), s, "amax")


def _lo_sum(band, elf, erf, m, featc3, ns, keep, cd, seg):
    """Leftover num/den: per-edge E, then ONE CSR segment sum (K1) of the
    packed [E·feat | E] table in the compute dtype."""
    n, h, d = featc3.shape
    e, _, s_ids, _ = _lo_e(band, elf, erf, m, ns, keep, False)
    msg = (e.to(cd)[:, :, None] * featc3[s_ids]).reshape(-1, h * d)
    agg = seg(_pad8(torch.cat([msg, e.to(cd)], 1)), band.lo_row_ptr)
    return agg[:, :h * d].float().reshape(n, h, d), agg[:, h * d:h * d + h].float()


def _lo_der(band, elf, erf, m, featc3, gnum3, gden, ns, keep, seg):
    e, z, s_ids, r_ids = _lo_e(band, elf, erf, m, ns, keep, False)
    q = (gnum3[r_ids].float() * featc3[s_ids].float()).sum(-1) + gden[r_ids]
    return seg(_pad8(e * q * _dlrelu(z, ns)), band.lo_row_ptr)[:, :erf.shape[1]]


def _lo_dsend(band_bwd, elf, erf, m, featc3, gnum3, gden, ns, keep, cd, seg):
    """d_el/d_feat over the transpose band's leftover (sorted by its
    receivers, our senders): one K1 sum of the packed [E·gnum | t] table."""
    n, h, d = featc3.shape
    e, z, s_ids, r_ids = _lo_e(band_bwd, elf, erf, m, ns, keep, True)
    gn_e = gnum3[r_ids]
    q = (gn_e.float() * featc3[s_ids].float()).sum(-1) + gden[r_ids]
    t = e * q * _dlrelu(z, ns)
    packed = torch.cat([(e.to(cd)[:, :, None] * gn_e).reshape(-1, h * d), t.to(cd)], 1)
    agg = seg(_pad8(packed), band_bwd.lo_row_ptr)
    return agg[:, h * d:h * d + h].float(), agg[:, :h * d].float().reshape(n, h, d)


# ---------------------------------------------------------------------------
# the aggregation and its backward
# ---------------------------------------------------------------------------

def other_maxima(band: Band, elf: torch.Tensor, erf: torch.Tensor, ns: float, keeps: Keeps,
                 self_score: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``m_other`` [N, H] of K7: the per-receiver maximum score over the
    structures outside the kernel (hub columns past its cap, hub rows,
    leftover, self term), NEG where there are none."""
    n, h = erf.shape
    m_other = torch.full((n, h), NEG, dtype=torch.float32, device=erf.device)
    if keeps.cols is not None:
        m_other = torch.maximum(m_other, _hubcol_max(band, elf, erf, ns, keeps.cols))
    if keeps.rows is not None:
        m_rows = _hubrow_max(band, elf, erf, ns, keeps.rows)
        m_other.scatter_reduce_(0, band.hub_row_ids.long()[:, None].expand(-1, h), m_rows,
                                "amax")
    if band.n_lo:
        m_other = torch.maximum(m_other, _lo_max(band, elf, erf, ns, keeps.lo))
    if self_score is not None:
        m_other = torch.maximum(m_other, self_score.detach().float())
    return m_other.contiguous()


def _agg_fwd(feat, el, er, self_score, self_feat, self_count, band, drop, ns, cd, ops):
    """(num [N, H, D], den [N, H], M [N, H], the forward band's keeps) in the
    JAX package's order (`_agg_fwd_impl`, `gat_dense.py:691-754`)."""
    fused, seg = ops[0], ops[3]
    n, h, d = feat.shape
    elf, erf = el.float().contiguous(), er.float().contiguous()
    featc = feat.to(cd).reshape(n, h * d).contiguous()
    featc3 = featc.reshape(n, h, d)
    keeps = Keeps(band, drop, False)
    # the exact stabilizer: the PyTorch passes' maxima first, then K7
    # completes M over the window and its hub columns
    m_other = other_maxima(band, elf, erf, ns, keeps, self_score)
    num, den, m = fused(band, elf, erf, m_other, featc, ns, drop)
    num = num.reshape(n, h, d)
    if keeps.cols is not None:
        num_hc, den_hc = _hubcol_sum(band, elf, erf, m, featc3, ns, keeps.cols, cd)
        num = num + num_hc
        den = den + den_hc
    if keeps.rows is not None:
        ids = band.hub_row_ids.long()
        num_hr, den_hr = _hubrow_sum(band, elf, erf, m[ids], featc3, ns, keeps.rows, cd)
        num = num.index_add(0, ids, num_hr)
        den = den.index_add(0, ids, den_hr)
    if band.n_lo:
        num_lo, den_lo = _lo_sum(band, elf, erf, m, featc3, ns, keeps.lo, cd, seg)
        num = num + num_lo
        den = den + den_lo
    if self_score is not None:
        # neighbours + exactly one self: the analytic term weighted by
        # (1 − #explicit self edges) cancels the self edges already counted
        # by the structures above (they share the stabilizer M)
        w_self = (1.0 - self_count.float())[:, None] * torch.exp(self_score.detach().float() - m)
        den = den + w_self
        num = num + w_self[:, :, None] * self_feat.detach().float()
    return num, den, m, keeps


def _agg_bwd(feat, el, er, self_score, self_feat, self_count, m, keeps_f, bands, drop, ns,
             cd, ops, g_num, g_den):
    """The manual VJP (`gat_dense.py:783-844`): d_er over the forward
    structures, d_el and d_feat over the transpose band's."""
    _, der_k, dsend_k, seg = ops
    band, bwd = bands.fwd, bands.bwd
    n, h, d = feat.shape
    elf, erf = el.float().contiguous(), er.float().contiguous()
    featc = feat.to(cd).reshape(n, h * d).contiguous()
    featc3 = featc.reshape(n, h, d)
    g_num = g_num.float()
    g_den = g_den.float().contiguous()
    gnum_c = g_num.to(cd).reshape(n, h * d).contiguous()
    gnum3 = gnum_c.reshape(n, h, d)

    d_er = der_k(band, elf, erf, m, featc, gnum_c, g_den, ns, drop)
    if keeps_f.cols is not None:
        d_er = d_er + _hubcol_der(band, elf, erf, m, featc3, gnum3, g_den, ns, keeps_f.cols)
    if keeps_f.rows is not None:
        ids = band.hub_row_ids.long()
        d_er = d_er.index_add(0, ids, _hubrow_der(band, elf, erf, m[ids], featc3, gnum3[ids],
                                                  g_den[ids], ns, keeps_f.rows))
    if band.n_lo:
        d_er = d_er + _lo_der(band, elf, erf, m, featc3, gnum3, g_den, ns, keeps_f.lo, seg)

    keeps_b = Keeps(bwd, drop, True)
    d_el, d_feat = dsend_k(bwd, elf, erf, m, featc, gnum_c, g_den, ns, drop)
    d_feat = d_feat.reshape(n, h, d)
    if keeps_b.cols is not None:
        del_hc, df_hc = _hubcol_dsend(bwd, elf, erf, m, featc3, gnum3, g_den, ns, keeps_b.cols,
                                      cd)
        d_el = d_el + del_hc
        d_feat = d_feat + df_hc
    if keeps_b.rows is not None:
        ids = bwd.hub_row_ids.long()
        del_hr, df_hr = _hubrow_dsend(bwd, elf, erf, m, featc3, gnum3, g_den, ns, keeps_b.rows,
                                      cd)
        d_el = d_el.index_add(0, ids, del_hr)
        d_feat = d_feat.index_add(0, ids, df_hr)
    if bwd.n_lo:
        del_lo, df_lo = _lo_dsend(bwd, elf, erf, m, featc3, gnum3, g_den, ns, keeps_b.lo, cd,
                                  seg)
        d_el = d_el + del_lo
        d_feat = d_feat + df_lo

    d_ss = d_sf = None
    if self_score is not None:
        w_self = (1.0 - self_count.float())[:, None] * torch.exp(self_score.float() - m)
        qs = (g_num * self_feat.float()).sum(-1) + g_den
        d_ss = (w_self * qs).to(self_score.dtype)
        d_sf = (w_self[:, :, None] * g_num).to(self_feat.dtype)
    return (d_feat.to(feat.dtype), d_el.to(el.dtype), d_er.to(er.dtype), d_ss, d_sf)


class _GatDenseAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, el, er, self_score, self_feat, self_count, bands, drop, neg_slope,
                cd, ops):
        num, den, m, keeps = _agg_fwd(feat, el, er, self_score, self_feat, self_count,
                                      bands.fwd, drop, neg_slope, cd, ops)
        ctx.save_for_backward(feat, el, er, self_score, self_feat, self_count, m)
        ctx.keeps, ctx.bands, ctx.drop, ctx.ns, ctx.cd, ctx.ops = (keeps, bands, drop,
                                                                   neg_slope, cd, ops)
        return num, den

    @staticmethod
    def backward(ctx, g_num, g_den):
        feat, el, er, self_score, self_feat, self_count, m = ctx.saved_tensors
        n, h, d = feat.shape
        if g_num is None:
            g_num = torch.zeros((n, h, d), dtype=torch.float32, device=feat.device)
        if g_den is None:
            g_den = torch.zeros((n, h), dtype=torch.float32, device=feat.device)
        grads = _agg_bwd(feat, el, er, self_score, self_feat, self_count, m, ctx.keeps,
                         ctx.bands, ctx.drop, ctx.ns, ctx.cd, ctx.ops, g_num, g_den)
        return grads + (None,) * 6


_KERNELS = (win_fused, win_der, win_dsend, csr_seg_sum)
_PLAIN = (win_fused_plain, win_der_plain, win_dsend_plain, csr_seg_sum_plain)


def _apply(ops, feat, el, er, self_score, self_feat, self_count, bands, drop, neg_slope,
           cdt):
    _require(self_score is None or drop is None,
             "the self-loop flavour and edge-drop are not composed (PyG's GATConv has no "
             "edge-drop)")
    cd = cdt if cdt is not None else feat.dtype
    return _GatDenseAgg.apply(feat, el, er, self_score, self_feat, self_count, bands, drop,
                              neg_slope, cd, ops)


def gat_dense_agg(feat: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                  self_score: Optional[torch.Tensor], self_feat: Optional[torch.Tensor],
                  self_count: Optional[torch.Tensor], bands: BandPair,
                  drop: Optional[DropSpec] = None, neg_slope: float = 0.2,
                  cdt: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hub-capable dense destination-score GAT aggregation (module
    docstring), on K7–K9 and K1.

    feat [N, H, D] (pre-scaled), el/er [N, H] the halves of the logit before
    the leaky ReLU. Returns (num [N, H, D], den [N, H]) in float32; the caller
    divides with its own guard. PyG's self flavour passes self_score [N, H],
    self_feat [N, H, D] and self_count [N] (explicit self edges per node);
    ``drop`` is the hash edge-drop (not with the self flavour); ``cdt`` the
    compute dtype of the feature tables (feat's by default)."""
    return _apply(_KERNELS, feat, el, er, self_score, self_feat, self_count, bands, drop,
                  neg_slope, cdt)


def gat_dense_agg_plain(feat, el, er, self_score, self_feat, self_count, bands: BandPair,
                        drop: Optional[DropSpec] = None, neg_slope: float = 0.2,
                        cdt: Optional[torch.dtype] = None):
    """The same Function on the plain versions of K7–K9 and K1, on any
    device: the oracle the kernels' forward and backward are held against."""
    return _apply(_PLAIN, feat, el, er, self_score, self_feat, self_count, bands, drop,
                  neg_slope, cdt)

