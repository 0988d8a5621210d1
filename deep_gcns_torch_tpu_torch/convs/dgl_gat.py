"""The DGL-flavour GAT conv of RevGAT (counterpart of
`deep_gcns_torch_tpu/convs/dgl_gat.py:62-276`, reference
`examples/ogb_eff/ogbn_arxiv_dgl/model_rev.py:51-194`).

* score_e = leaky_relu(a_l·(W h)[send_e] [+ a_r·(W h)[recv_e]]), per head;
* optional symmetric norm: the sender features scaled by out_deg^-1/2 before
  the aggregation, the result by in_deg^1/2 after;
* edge-drop: the hash keep decision of (receiver, sender, key) removes edges
  BEFORE the softmax, so the attention renormalises over the kept edges;
* optional residual Linear (no bias); xavier-normal inits with gain √2.

Routes, in the JAX package's order (`convs/dgl_gat.py:195-268`):
1. the dense route on a band that passes `band_gat_dense_ok`: destination
   scores with er = ⟨feat, a_r⟩ (the unscaled features: the symmetric norm
   scales only the sender side), or the ``per_receiver`` stabilizer with
   er ≡ 0; `band_gat_dense_agg`, K7 forward, K8 and K9 backward, K1 for the
   leftover, with the exact per-receiver stabilizer;
2. `band_gat_agg` when a band passes `band_sum_ok`: one band product of the
   packed node table (K3, K1 for the leftover);
3. `gat_softmax_spmm` when the graph has its CSR and CSC: K5 forward, K6
   backward. The JAX package takes it on a TPU only; the port whenever the
   arrays are there;
4. otherwise the per-edge segment softmax with `gather_src_auto` (K1 in the
   backward when the graph has its CSC).
Routes 2 and 3 shift by one global maximum per head. Without a band the
``per_receiver`` stabilizer takes route 4, whose softmax is per receiver
too, where the JAX package would fall back to a global shift on a TPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..graph import Graph
from ..nn.core import Linear
from ..ops.band import (DropSpec, band_gat_agg, band_gat_dense_agg, band_gat_dense_ok,
                        band_sum_ok, drop_thresh, edge_keep_mask)
from ..ops.gather import gather_src_auto
from ..ops.segment import segment_degree, segment_softmax, segment_sum
from ..ops.spmm_cuda import gat_softmax_spmm
from ..utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Backward-reciprocal floor of the global-shift routes (`DEN_TINY`,
# `convs/dgl_gat.py:63-75`): a receiver whose shifted den fell below it
# outputs 0 with zero gradients instead of 1/den → inf → NaN.
DEN_TINY = 1e-20


class _SafeDiv(torch.autograd.Function):
    """num [N, H, D] / den [N, H], 0 where den ≤ DEN_TINY, with the JAX
    package's reassociated backward (`_safe_div`, `convs/dgl_gat.py:78-106`):
    d_den = −⟨g, out⟩/den, never −⟨g, num⟩/den², whose square underflows
    float32 for den ≲ 1e-19."""

    @staticmethod
    def forward(ctx, num, den):
        ok = den > DEN_TINY
        dsafe = torch.where(ok, den, 1.0)
        out = torch.where(ok[..., None], num / dsafe[..., None], 0.0)
        ctx.save_for_backward(out, dsafe, ok)
        return out

    @staticmethod
    def backward(ctx, g):
        out, dsafe, ok = ctx.saved_tensors
        d_num = torch.where(ok[..., None], g / dsafe[..., None], 0.0)
        d_den = torch.where(ok, -(g * out).sum(-1) / dsafe, 0.0)
        return d_num, d_den


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return _SafeDiv.apply(num, den)


def _xavier_normal_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]):
    """N(0, std²) with std = √2·√(2/(fan_in + fan_out)), the JAX package's
    fans (`convs/dgl_gat.py:135-153`)."""
    std = math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


class SymGATConv(nn.Module):
    """GAT conv with the reference's parameter names: ``fc.weight``
    [H·D, in], ``attn_l`` and ``attn_r`` [1, H, D], ``res_fc.weight``.
    Returns [N, H, D]; the caller flattens or averages the heads."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1,
                 edge_drop: float = 0.0, neg_slope: float = 0.2, use_attn_dst: bool = True,
                 residual: bool = False, use_symmetric_norm: bool = False,
                 compute_dtype: str = "float32", stabilizer: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stabilizer not in ("auto", "per_receiver"):
            raise ValueError(f"unknown stabilizer {stabilizer!r}")
        h, d = num_heads, out_dim
        self.num_heads, self.out_dim = h, d
        self.edge_drop, self.neg_slope = edge_drop, neg_slope
        self.use_attn_dst, self.use_symmetric_norm = use_attn_dst, use_symmetric_norm
        self.compute_dtype = _DTYPES[compute_dtype]
        self.stabilizer = stabilizer
        self.fc = Linear(in_dim, h * d, bias=False, generator=generator)
        _xavier_normal_(self.fc.weight, in_dim, h * d, generator)
        self.attn_l = nn.Parameter(torch.empty(1, h, d))
        _xavier_normal_(self.attn_l, d, 1, generator)
        self.attn_r = None
        if use_attn_dst:
            self.attn_r = nn.Parameter(torch.empty(1, h, d))
            _xavier_normal_(self.attn_r, d, 1, generator)
        self.res_fc = None
        if residual:
            self.res_fc = Linear(in_dim, h * d, bias=False, generator=generator)
            _xavier_normal_(self.res_fc.weight, in_dim, h * d, generator)

    def forward(self, x: torch.Tensor, g: Graph, train: bool = False,
                drop_key: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``drop_key``: an int32 pair, needed in training when edge_drop > 0;
        the keep decision is the hash of (receiver, sender, key), the same in
        the band kernel, its transpose and the per-edge routes."""
        n = x.shape[0]
        h, d = self.num_heads, self.out_dim
        if train and self.edge_drop > 0 and drop_key is None:
            raise ValueError("edge_drop > 0 in training needs a drop_key")
        with span("conv.linear"):
            feat = self.fc(x).reshape(n, h, d)
        with span("conv.attend"):
            out = self._attend(feat, g, train, drop_key)
        if self.res_fc is not None:
            with span("conv.linear"):
                res = self.res_fc(x).reshape(n, h, d)
            out = out + res
        return out

    def _attend(self, feat: torch.Tensor, g: Graph, train: bool,
                drop_key: Optional[Sequence[int]]) -> torch.Tensor:
        """From the sender-side symmetric scaling through the edge-drop
        decision, the scores and the route's aggregation to the
        receiver-side scaling: [N, H, D]."""
        n, h, d = feat.shape
        drop = keep_mask = None
        if train and self.edge_drop > 0:
            drop = DropSpec(k0=int(drop_key[0]), k1=int(drop_key[1]),
                            thresh=drop_thresh(self.edge_drop))
            keep_mask = edge_keep_mask(drop, g.receivers, g.senders)
        emask = g.edge_mask
        feat_src = feat
        if self.use_symmetric_norm:
            out_deg = segment_degree(g.senders, n, emask)
            feat_src = feat * torch.pow(torch.clamp_min(out_deg, 1.0), -0.5)[:, None, None]
        el = (feat_src * self.attn_l).sum(-1)
        att_mask = emask if keep_mask is None else emask & (keep_mask > 0)
        cd = self.compute_dtype if self.compute_dtype == torch.bfloat16 else feat_src.dtype

        er = (feat * self.attn_r).sum(-1) if self.use_attn_dst else None
        # the global-shift routes serve sender-only scores under "auto" only
        global_shift = not self.use_attn_dst and self.stabilizer == "auto"
        if (self.use_attn_dst or self.stabilizer == "per_receiver") and band_gat_dense_ok(g):
            if er is None:
                er = torch.zeros_like(el)
            out = safe_div(*band_gat_dense_agg(feat_src, el, er, g.band, self.neg_slope, cd,
                                               drop))
        elif global_shift and band_sum_ok(g):
            out = safe_div(*band_gat_agg(feat_src, el, g.band, self.neg_slope, cd, drop))
        elif (global_shift and g.row_ptr is not None and g.csc_col_ptr is not None
                and g.csc_receivers is not None):
            out = self._csc(feat_src, el, g, att_mask, keep_mask, cd)
        else:
            score = el.index_select(0, torch.clamp(g.senders.long(), max=n - 1))
            if er is not None:
                score = score + er.index_select(0, torch.clamp(g.receivers.long(), max=n - 1))
            score = torch.nn.functional.leaky_relu(score, self.neg_slope)
            alpha = segment_softmax(score, g.receivers, n, mask=att_mask)
            msg = gather_src_auto(feat_src.reshape(n, h * d), g).reshape(-1, h, d)
            out = segment_sum(msg * alpha[..., None], g.receivers, n, mask=att_mask)

        if self.use_symmetric_norm:
            in_deg = segment_degree(g.receivers, n, emask)
            out = out * torch.pow(torch.clamp_min(in_deg, 1.0), 0.5)[:, None, None]
        return out

    def _csc(self, feat_src, el, g: Graph, att_mask, keep_mask, cd):
        """The fused route: the packed table [feat_src | el] (zero-padded to a
        multiple of 8 columns for the kernels' wide loads) through K5/K6;
        dropped edges carry the sentinel receiver N_pad."""
        n, h, d = feat_src.shape
        t = torch.cat([feat_src.reshape(n, h * d), el], 1)
        t = torch.nn.functional.pad(t, (0, (-t.shape[1]) % 8)).to(cd)
        recv_eff = torch.where(att_mask, g.receivers, n)
        keep_csc = None if keep_mask is None else keep_mask.index_select(0, g.csc_perm.long())
        agg = gat_softmax_spmm(t, g.senders, recv_eff, g.row_ptr, g.csc_senders,
                               g.csc_receivers, g.csc_col_ptr, keep_csc, h * d, h,
                               self.neg_slope)
        num = agg[:, :h * d].float().reshape(n, h, d)
        return safe_div(num, agg[:, h * d:h * d + h].float())
