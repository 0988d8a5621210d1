"""The port's block-sparse SpMM (`ops/blocksparse.py`) against the JAX
package's: the host tile arrays bit for bit, and `block_spmm` forward and
gradient against JAX's `block_spmm(..., interpret=True)` on the CPU, on the
cases of tests/test_blocksparse.py (rtol 3e-4, atol 1e-4 there: the JAX
kernel sums per tile, the port per receiver in tile order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu.ops import blocksparse as jbs
from deep_gcns_torch_tpu_torch.ops import blocksparse as tbs
from torch_budget import budget  # noqa: F401

TOL = dict(rtol=3e-4, atol=1e-4)


def banded_graph(rng, n, deg, bandwidth):
    s = rng.integers(0, n, n * deg)
    r = np.clip(s + rng.integers(-bandwidth, bandwidth + 1, n * deg), 0, n - 1)
    return s, r


def _assert_tiles_equal(jt, tt):
    assert tt.n_blocks == jt.n_blocks and tt.n_edges == jt.n_edges
    np.testing.assert_array_equal(tt.tile_start.numpy(), np.asarray(jt.tile_start))
    assert tt.tile_start.dtype == torch.int32 and tt.tile_sb.dtype == torch.int32
    np.testing.assert_array_equal(tt.tile_sb.numpy(), np.asarray(jt.tile_sb))
    np.testing.assert_array_equal(tt.offs.numpy().astype(np.int32),
                                  np.asarray(jt.offs)[:, :2])
    assert tt.fill == jt.fill


def _jax_grad(x, tiles, tiles_t, co):
    return jax.jit(jax.grad(lambda x_: jnp.sum(jbs.block_spmm(x_, tiles, tiles_t, True) * co)))(x)


def _torch_out_grad(x, tiles, tiles_t, co):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tbs.block_spmm(xt, tiles, tiles_t)
    (out * torch.from_numpy(co)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("bandwidth", [100, 1000])
def test_forward_and_grad_match_jax(bandwidth):
    rng = np.random.default_rng(bandwidth)
    n = 2 * jbs.SB
    s, r = banded_graph(rng, n, 6, bandwidth)
    x = rng.standard_normal((n, 128)).astype(np.float32)
    co = rng.standard_normal((n, 128)).astype(np.float32)
    jt, jtt = jbs.build_block_tiles(s, r, n)
    tt, ttt = tbs.build_block_tiles(s, r, n)
    _assert_tiles_equal(jt, tt)
    _assert_tiles_equal(jtt, ttt)
    out, grad = _torch_out_grad(x, tt, ttt, co)
    np.testing.assert_allclose(out, np.asarray(jbs.block_spmm(jnp.asarray(x), jt, jtt, True)),
                               **TOL)
    np.testing.assert_allclose(grad, np.asarray(_jax_grad(jnp.asarray(x), jt, jtt,
                                                          jnp.asarray(co))), **TOL)


def test_host_arrays_bit_identical_multi_tile_pairs():
    """A pair with more than T edges is cut into several tiles, multi-edges
    and self edges included, at several blocks."""
    rng = np.random.default_rng(7)
    n = 5 * jbs.SB
    s, r = banded_graph(rng, n, 9, 40)
    s = np.concatenate([s, np.full(700, 3), np.arange(n)])
    r = np.concatenate([r, np.full(700, 5), np.arange(n)])
    jt, jtt = jbs.build_block_tiles(s, r, n)
    tt, ttt = tbs.build_block_tiles(s, r, n)
    assert tt.n_tiles > n // jbs.BN
    _assert_tiles_equal(jt, tt)
    _assert_tiles_equal(jtt, ttt)
    send, recv = tt.edges()
    assert sorted(zip(send.tolist(), recv.tolist())) == sorted(zip(s.tolist(), r.tolist()))


def test_empty_receiver_block_is_exact_zero():
    rng = np.random.default_rng(1)
    n = 2 * jbs.SB
    s = rng.integers(0, n, 500)
    r = rng.integers(jbs.BN, 2 * jbs.BN, 500)
    x = rng.standard_normal((n, 128)).astype(np.float32)
    jt, jtt = jbs.build_block_tiles(s, r, n)
    tt, ttt = tbs.build_block_tiles(s, r, n)
    _assert_tiles_equal(jt, tt)
    got = tbs.block_spmm(torch.from_numpy(x), tt, ttt).numpy()
    np.testing.assert_allclose(got, np.asarray(jbs.block_spmm(jnp.asarray(x), jt, jtt, True)),
                               rtol=1e-5, atol=1e-5)
    assert np.all(got[:jbs.BN] == 0)


def test_empty_graph():
    """No edges: no tiles, `tile_start` all 0, the one sentinel tile of the
    JAX builder's `max(nt, 1)`, and an output of exact zeros (JAX's reference
    segment sum over no edges). The JAX builder itself raises here
    (`rbo[0]` of an empty array)."""
    n = 3 * jbs.SB
    e = np.zeros(0, np.int64)
    with pytest.raises(IndexError):
        jbs.build_block_tiles(e, e, n)
    tt, ttt = tbs.build_block_tiles(e, e, n)
    for t in (tt, ttt):
        assert t.n_tiles == 0 and t.n_edges == 0 and t.fill == 0.0
        np.testing.assert_array_equal(t.tile_start.numpy(), np.zeros(4, np.int32))
        assert t.offs.shape == (1, 2, jbs.T) and bool((t.offs == 128).all())
    x = torch.randn(n, 16, requires_grad=True)
    out = tbs.block_spmm(x, tt, ttt)
    want = jax.ops.segment_sum(jnp.zeros((0, 16)), jnp.zeros(0, jnp.int32), n)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    out.sum().backward()
    assert bool((x.grad == 0).all())


def test_fill_orders_band_above_er():
    rng = np.random.default_rng(2)
    n = 2 * jbs.SB
    s, r = banded_graph(rng, n, 20, 64)
    s2, r2 = rng.integers(0, n, n * 4), rng.integers(0, n, n * 4)
    band, _ = tbs.build_block_tiles(s, r, n)
    er, _ = tbs.build_block_tiles(s2, r2, n)
    assert 0.0 < er.fill < band.fill <= 1.0
    assert band.fill == jbs.build_block_tiles(s, r, n)[0].fill
    assert er.fill == jbs.build_block_tiles(s2, r2, n)[0].fill


def test_any_channel_count_matches_jax_zero_padded():
    """C = 40 is not a multiple of 128: the port takes it as it is and
    agrees with JAX at C = 128 on zero-padded columns."""
    rng = np.random.default_rng(3)
    n = 2 * jbs.SB
    s, r = banded_graph(rng, n, 6, 100)
    x = rng.standard_normal((n, 40)).astype(np.float32)
    co = rng.standard_normal((n, 40)).astype(np.float32)
    jt, jtt = jbs.build_block_tiles(s, r, n)
    tt, ttt = tbs.build_block_tiles(s, r, n)
    out, grad = _torch_out_grad(x, tt, ttt, co)
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, 88))))
    cop = jnp.asarray(np.pad(co, ((0, 0), (0, 88))))
    np.testing.assert_allclose(out, np.asarray(jbs.block_spmm(xp, jt, jtt, True))[:, :40],
                               **TOL)
    np.testing.assert_allclose(grad, np.asarray(_jax_grad(xp, jt, jtt, cop))[:, :40], **TOL)


def test_plain_twin_and_bf16_round_once():
    """`block_spmm_plain` is the same Function on the plain version; in
    bf16 the float32 sum rounds once to bf16."""
    rng = np.random.default_rng(4)
    n = 2 * jbs.SB
    s, r = banded_graph(rng, n, 6, 200)
    tt, ttt = tbs.build_block_tiles(s, r, n)
    x = torch.from_numpy(rng.standard_normal((n, 24)).astype(np.float32))
    torch.testing.assert_close(tbs.block_spmm_plain(x, tt, ttt), tbs.block_spmm(x, tt, ttt),
                               rtol=0, atol=0)
    xb = x.to(torch.bfloat16)
    want = torch.zeros(n, 24).index_add_(0, torch.from_numpy(r), xb.float()[s]).to(torch.bfloat16)
    torch.testing.assert_close(tbs.block_spmm(xb, tt, ttt), want, rtol=1e-2, atol=1e-2)
    assert tbs.block_spmm(xb, tt, ttt).dtype == torch.bfloat16


def test_n_pad_must_be_a_block_multiple():
    with pytest.raises(ValueError):
        tbs.build_block_tiles(np.zeros(1, np.int64), np.zeros(1, np.int64), 200)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_multi_edge_cells_above_256_match_jax(dtype):
    """One (r, s) edge 300 times in a tile beside others, and one 520 times
    (a full tile of 512 copies, then 8 more): counts that bf16 cannot hold
    as one value, which the card's tensor-core form splits. The plain
    version against JAX's `_bsp_spmm_call` in interpret mode; integer-valued
    x keeps every float32 sum exact, so the two agree bit for bit."""
    rng = np.random.default_rng(8)
    n = 4 * jbs.SB
    s, r = banded_graph(rng, n, 6, 150)
    s = np.concatenate([s, np.full(300, jbs.SB + 7), np.full(520, 3 * jbs.SB + 100)])
    r = np.concatenate([r, np.full(300, 5), np.full(520, 2 * jbs.SB + 1)])
    x = rng.integers(-8, 9, (n, 128)).astype(np.float32)
    jt, jtt = jbs.build_block_tiles(s, r, n)
    tt, ttt = tbs.build_block_tiles(s, r, n)
    _assert_tiles_equal(jt, tt)
    _assert_tiles_equal(jtt, ttt)
    assert tt.n_tiles > len(np.unique((r // jbs.BN) * (n // jbs.SB) + s // jbs.SB))
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    for j, t in ((jt, tt), (jtt, ttt)):
        want = np.asarray(jbs._bsp_spmm_call(jnp.asarray(x, dtype), j, True), np.float32)
        got = tbs.bsp_call_plain(xt, t).float().numpy()
        np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 256
