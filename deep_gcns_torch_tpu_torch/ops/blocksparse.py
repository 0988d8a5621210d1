"""Block-sparse SpMM (K10): out = A @ x over host-built edge tiles, with the
backward on the transpose tiles (counterpart of
`deep_gcns_torch_tpu/ops/blocksparse.py`).

Host side: the edges are sorted by (receiver block rb = r // 128, sender
block sb = s // 128, sender) and cut into tiles of at most T = 512 edges of
one (rb, sb) pair, tiles ordered by rb; `tile_start[rb]` gives a receiver
block's range of tiles. Each tile keeps its edges' sender offset in the
sender block (row 0 of `offs`) and receiver offset in the receiver block
(row 1); the sentinel 128 fills the unused slots and matches no row. The
arrays are bit for bit those of `build_block_tiles` in the JAX package, built
here without a Python loop over tiles; `offs` keeps only the two rows the
card reads (rows 2-7 there are Mosaic padding), as uint8.

Device side: `block_spmm(x, tiles, tiles_t)` is one autograd Function. Its
forward runs K10 (`csrc/blocksparse.cu`) on ``tiles``, its backward K10 on
``tiles_t`` (dx = Aᵀ g). A CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises; `block_spmm.launches` counts the launches.
K10 rebuilds each tile as a dense [128, 128] block of edge counts in shared
memory and multiplies it with the sender block on the tensor cores (float32
x as three bf16 parts): the products are exact, and their float32
accumulation follows the tensor cores' adder, so its sums differ from the
plain version's `index_add_` in order and in rounding, within the tests'
float32 tolerance. Any channel count works (the TPU kernel's
`c % 128 == 0` is lane layout); the node count must be a multiple of 128.

No route of the JAX package calls this module; it is ported as a module and
a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from ._build import library

BN = 128    # receiver rows per output block
SB = 128    # sender rows per source block
T = 512     # edge slots per tile
SENTINEL = max(SB, BN)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@dataclass(frozen=True)
class BlockTiles:
    """One direction's tile structure (A or Aᵀ)."""

    tile_start: torch.Tensor  # [NB + 1] int32: tiles of receiver block b are
                              # [tile_start[b], tile_start[b + 1])
    tile_sb: torch.Tensor     # [Nt] int32: sender block of each tile
    offs: torch.Tensor        # [max(Nt, 1), 2, T] uint8: sender / receiver offset
                              # of each slot, SENTINEL in unused slots
    n_blocks: int = 0
    n_edges: int = 0

    @property
    def n_tiles(self) -> int:
        return int(self.tile_sb.shape[0])

    @property
    def fill(self) -> float:
        """Fraction of tile slots holding real edges."""
        return self.n_edges / max(self.n_tiles * T, 1)

    def to(self, device) -> "BlockTiles":
        return replace(self, tile_start=self.tile_start.to(device),
                       tile_sb=self.tile_sb.to(device), offs=self.offs.to(device))

    def edges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(senders, receivers) of the real edges, int64, in tile order."""
        nt = self.n_tiles
        dev = self.offs.device
        counts = (self.tile_start[1:] - self.tile_start[:-1]).long()
        tile_rb = torch.repeat_interleave(torch.arange(self.n_blocks, device=dev), counts)
        so = self.offs[:nt, 0].long()
        ro = self.offs[:nt, 1].long()
        real = so < SB
        send = (self.tile_sb.long()[:, None] * SB + so)[real]
        recv = (tile_rb[:, None] * BN + ro)[real]
        return send, recv


def _build_one(senders: np.ndarray, receivers: np.ndarray, n_blocks: int) -> BlockTiles:
    rb = receivers // BN
    sb = senders // SB
    order = np.lexsort((senders, sb, rb))
    s, r, rbo, sbo = senders[order], receivers[order], rb[order], sb[order]
    e = len(s)
    # tile boundaries: a new (rb, sb) pair, or every T edges inside one
    pair = rbo * n_blocks + sbo
    new_pair = np.ones(e, bool)
    new_pair[1:] = pair[1:] != pair[:-1]
    pstart = np.flatnonzero(new_pair)
    within = np.arange(e) - np.repeat(pstart, np.diff(np.append(pstart, e)))
    is_start = within % T == 0
    starts = np.flatnonzero(is_start)
    nt = len(starts)
    offs = np.full((max(nt, 1), 2, T), SENTINEL, np.uint8)
    tile_of, slot = np.cumsum(is_start) - 1, within % T
    offs[tile_of, 0, slot] = s % SB
    offs[tile_of, 1, slot] = r % BN
    tile_start = np.searchsorted(rbo[starts], np.arange(n_blocks + 1)).astype(np.int32)
    return BlockTiles(tile_start=torch.from_numpy(tile_start),
                      tile_sb=torch.from_numpy(sbo[starts].astype(np.int32)),
                      offs=torch.from_numpy(offs), n_blocks=n_blocks, n_edges=e)


def build_block_tiles(senders: np.ndarray, receivers: np.ndarray, n_pad: int
                      ) -> Tuple[BlockTiles, BlockTiles]:
    """Host-side tile structures for A (forward) and Aᵀ (backward), on the
    CPU. ``n_pad`` must be a multiple of 128; senders/receivers are the valid
    edges only. An empty edge list gives no tiles (the JAX builder raises on
    it)."""
    if n_pad % SB != 0:
        raise ValueError(f"n_pad={n_pad} must be a multiple of {SB}")
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    nb = n_pad // BN
    return _build_one(senders, receivers, nb), _build_one(receivers, senders, nb)


# ---------------------------------------------------------------------------
# K10 and its plain version
# ---------------------------------------------------------------------------

def bsp_call_plain(x: torch.Tensor, tiles: BlockTiles) -> torch.Tensor:
    """out = A @ x: the tiles' edges, one float32 `index_add_` in tile order,
    rounded once to x's dtype."""
    send, recv = tiles.edges()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    out.index_add_(0, recv, x.index_select(0, send).float())
    return out.to(x.dtype)


def _check(tiles: BlockTiles, x: torch.Tensor):
    if x.dtype not in _SUFFIX or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a 2-D contiguous float32 or bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] != tiles.n_blocks * BN:
        raise ValueError(f"x has {x.shape[0]} rows, the tiles {tiles.n_blocks * BN}")
    for name, a, dtype in (("tile_start", tiles.tile_start, torch.int32),
                           ("tile_sb", tiles.tile_sb, torch.int32),
                           ("offs", tiles.offs, torch.uint8)):
        if a.device != x.device or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x.device}, "
                             f"got {a.dtype} on {a.device}")


def bsp_call(x: torch.Tensor, tiles: BlockTiles) -> torch.Tensor:
    """K10 (`csrc/blocksparse.cu`) on a CUDA tensor; the plain version on a
    CPU one."""
    if x.device.type == "cpu":
        return bsp_call_plain(x, tiles)
    _check(tiles, x)
    out = torch.empty_like(x)
    if tiles.n_blocks == 0 or x.shape[1] == 0:
        return out
    fn = getattr(library("blocksparse"), f"dgc_bsp_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), tiles.tile_start.data_ptr(), tiles.tile_sb.data_ptr(),
            tiles.offs.data_ptr(), out.data_ptr(), tiles.n_blocks, x.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream)
    block_spmm.launches += 1
    if rc != 0:
        raise RuntimeError(f"K10 block_spmm: CUDA launch failed with error {rc}")
    return out


class _BlockSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tiles, tiles_t, call):
        ctx.tiles_t, ctx.call = tiles_t, call
        return call(x.contiguous(), tiles)

    @staticmethod
    def backward(ctx, g):
        return ctx.call(g.contiguous(), ctx.tiles_t), None, None, None


def block_spmm(x: torch.Tensor, tiles: BlockTiles, tiles_t: BlockTiles) -> torch.Tensor:
    """out = A @ x for the 0/1 adjacency of ``tiles`` (out[r] = Σ_{e: recv=r}
    x[send_e]); backward Aᵀ @ g through ``tiles_t``."""
    return _BlockSpmm.apply(x, tiles, tiles_t, bsp_call)


block_spmm.launches = 0


def block_spmm_plain(x: torch.Tensor, tiles: BlockTiles, tiles_t: BlockTiles
                     ) -> torch.Tensor:
    """`block_spmm` on the plain version, on any device."""
    return _BlockSpmm.apply(x, tiles, tiles_t, bsp_call_plain)
