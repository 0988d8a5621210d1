"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs on a machine that has only PyTorch:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets up JAX for the other
test files.)

Tolerances (those of chip_smoke.py): each per-edge term of K1, K2 and K3 is
bit for bit the plain version's (K2's shift, each receiver's maximum score,
is exact in both); only the order of the float32 sums differs, so float32
agrees to 1e-5 relative and bfloat16 to one ulp (2^-7 relative) of the final
rounding, each above a floor of 1e-5 of the largest value, where sums of
mixed signs cancel. K2's float32 log-normaliser lse is held to the same
tolerance as the output it comes with.
"""

import numpy as np
import pytest
import torch

from deep_gcns_torch_tpu_torch.graph import attach_band, build_graph
from deep_gcns_torch_tpu_torch.models import DeeperGCN, DeeperGCNConfig, RevGCN, RevGCNConfig
from deep_gcns_torch_tpu_torch.nn.core import Linear
from deep_gcns_torch_tpu_torch.ops import band as tband
from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp

TOL = {torch.float32: dict(rtol=1e-5, atol_rel=1e-5),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol_rel=1e-5)}
# K2's lse is float32 in both dtypes, from the same bf16-rounded terms: only
# the order of den's float32 sum differs
TOL_LSE = TOL[torch.float32]
# the backward rounds each edge's d(x_j) term and the summed dx to x's dtype
TOL_BWD = {torch.float32: dict(rtol=1e-5, atol_rel=1e-5),
           torch.bfloat16: dict(rtol=2.0 ** -5, atol_rel=1e-4)}
# the band route's outputs in bf16: A @ x is K3's sum plus the hub products
# plus K1's leftover sum, each rounded to bf16 before the next `+`, and the
# softmax quotient divides two such sums, so one ulp of a partial sum can
# move the result by a few ulps of its own
TOL_BAND = {torch.float32: dict(rtol=1e-5, atol_rel=1e-5),
            torch.bfloat16: dict(rtol=2.0 ** -5, atol_rel=1e-4)}
# dt: a float32 sum over N*C terms with cancellation
TOL_DT = {torch.float32: dict(rtol=1e-4, atol_rel=0.0),
          torch.bfloat16: dict(rtol=1e-2, atol_rel=0.0)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run `pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py` on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(dev, c, seed=0, n=5000, e=60000):
    """A random graph with one hub row (8000 in-edges) and isolated nodes."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n - 100, e)
    r[:8000] = 7
    x = rng.standard_normal((n, c)).astype(np.float32)
    return build_graph(x, s, r, num_nodes=n).to(dev)


def _assert_close(got, want, rtol, atol_rel, ref_max=None):
    """|got − want| ≤ rtol·|want| + atol_rel·ref_max, ref_max defaulting to
    max|want|."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if ref_max is None:
        ref_max = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * ref_max + 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 30])
def test_forward_kernels_match_plain(cuda_device, dtype, c):
    """C=128 takes the 4-wide loads, C=30 the scalar ones."""
    g = _graph(cuda_device, c)
    tol = TOL[dtype]
    x = g.x.to(dtype).contiguous()
    t = torch.tensor([0.1], device=cuda_device)
    k1, k2 = tsp.csr_seg_sum.launches, tsp.softmax_agg.launches

    out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
    out_p, lse_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
    _assert_close(out, out_p, **tol)
    _assert_close(lse, lse_p, **TOL_LSE)
    msgs = torch.randn(g.num_edges_padded, c, device=cuda_device).to(dtype)
    _assert_close(tsp.csr_seg_sum(msgs, g.row_ptr), tsp.csr_seg_sum_plain(msgs, g.row_ptr),
                  **tol)
    _assert_close(tsp.csr_seg_sum(x, g.csc_col_ptr, g.csc_receivers),
                  tsp.csr_seg_sum_plain(x, g.csc_col_ptr, g.csc_receivers), **tol)
    torch.cuda.synchronize()
    assert (tsp.csr_seg_sum.launches - k1, tsp.softmax_agg.launches - k2) == (2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_weights", [False, True])
def test_fused_backward_matches_plain(cuda_device, dtype, grad_weights):
    g = _graph(cuda_device, 128, seed=1)
    x = g.x.to(dtype).contiguous()
    res = []
    for fn in (tsp.fused_softmax_gather_agg, tsp.fused_softmax_gather_agg_plain):
        xx = x.detach().clone().requires_grad_(True)
        tt = torch.tensor([0.1], device=cuda_device, requires_grad=grad_weights)
        o = fn(xx, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr,
               g.csc_order, tt, eps=1e-7, grad_weights=grad_weights)
        (o.float() ** 2).sum().backward()
        res.append((o.detach(), xx.grad, tt.grad))
    _assert_close(res[0][0], res[1][0], **TOL[dtype])
    _assert_close(res[0][1], res[1][1], **TOL_BWD[dtype])
    if grad_weights:
        _assert_close(res[0][2], res[1][2], **TOL_DT[dtype])


def _edge_inputs(g, c, dtype, seed=0):
    """x and edge embeddings in both edge orders, as an edge encoder makes
    them: Linear(8, C) of the raw features, so the padded rows carry the
    bias."""
    gen = torch.Generator(device=g.senders.device).manual_seed(seed)
    dev = g.senders.device
    x = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen).to(dtype)
    w = torch.randn(8, c, device=dev, generator=gen) * 0.5
    b = torch.randn(c, device=dev, generator=gen) * 0.1
    ee = (g.edge_attr @ w + b).to(dtype)
    ee_csc = (g.edge_attr_csc @ w + b).to(dtype)
    return x, ee, ee_csc


def _edge_graph(dev, seed=0, n=5000, e=60000):
    """_graph's shape with 8-dim edge features in both edge orders."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n - 100, e)
    r[:8000] = 7
    ea = rng.random((e, 8)).astype(np.float32)
    return build_graph(None, s, r, edge_attr=ea, num_nodes=n).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 64, 30])
def test_edge_kernels_match_plain(cuda_device, dtype, c):
    """K2 with edge embeddings and K4 (both branches) against their plain
    versions: C=40 and 64 take the 4-wide loads, C=30 the scalar ones. K4's
    per-edge output d(ee) is bit for bit the plain version's terms; dx and dt
    are sums in another order."""
    g = _edge_graph(cuda_device)
    tol = TOL[dtype]
    x, ee, ee_csc = _edge_inputs(g, c, dtype)
    t = torch.tensor([0.9], device=cuda_device)
    k2, k4 = tsp.softmax_agg.launches_ee, tsp.softmax_bwd_csc.launches
    out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    out_p, lse_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    _assert_close(out, out_p, **tol)
    _assert_close(lse, lse_p, **TOL_LSE)
    q = torch.randn(g.num_nodes_padded, c, device=cuda_device).to(dtype)
    for gw in (False, True):
        qo = torch.cat([q, out_p], 1).contiguous() if gw else q
        args = (x, ee_csc, qo, lse_p, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, gw)
        dx, dee, dt = tsp.softmax_bwd_csc(*args)
        dx_p, dee_p, dt_p = tsp.softmax_bwd_csc_plain(*args)
        _assert_close(dx, dx_p, **tol)
        _assert_close(dee, dee_p, **tol)
        assert not dee[g.n_edge:].any()  # padded rows are zero
        if gw:
            _assert_close(dt, dt_p, **TOL_DT[torch.float32])
        else:
            assert dt is None and dt_p is None
    torch.cuda.synchronize()
    assert (tsp.softmax_agg.launches_ee - k2, tsp.softmax_bwd_csc.launches - k4) == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_weights", [False, True])
def test_fused_with_edge_emb_matches_plain(cuda_device, dtype, grad_weights):
    """The fused Function with edge embeddings (K2 with `ee` forward, K4
    backward) against the same Function on the plain versions: out, dx, the
    cotangent of the sender-ordered embeddings and dt. With learned weights
    in bf16, one ulp of `out` moves the factor 1 + t·(m − out) of a single
    edge term by t·2^-8·|out|, which sets the floor."""
    g = _edge_graph(cuda_device, seed=1)
    x, ee, ee_csc = _edge_inputs(g, 40, dtype, seed=1)
    co = torch.randn(g.num_nodes_padded, 40, device=cuda_device)
    res = []
    for fn in (tsp.fused_softmax_gather_agg, tsp.fused_softmax_gather_agg_plain):
        xx = x.detach().clone().requires_grad_(True)
        ec = ee_csc.detach().clone().requires_grad_(True)
        tt = torch.tensor([1.0], device=cuda_device, requires_grad=grad_weights)
        o = fn(xx, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr,
               g.csc_order, tt, ee=ee, ee_csc=ec, eps=1e-7, grad_weights=grad_weights)
        (o.float() * co).sum().backward()
        res.append((o.detach(), xx.grad, ec.grad, tt.grad))
    bwd = dict(TOL_BWD[dtype])
    if grad_weights and dtype == torch.bfloat16:
        bwd["atol_rel"] = 2.0 ** -7
    _assert_close(res[0][0], res[1][0], **TOL[dtype])
    _assert_close(res[0][1], res[1][1], **bwd)
    _assert_close(res[0][2], res[1][2], **bwd)
    if grad_weights:
        _assert_close(res[0][3], res[1][3], **TOL_DT[dtype])


@pytest.mark.cuda
def test_small_rev_gcn_card_matches_cpu(cuda_device):
    """A 3-layer RevGCN (group 2, edge encoders, learned t) through the
    reversible engine and K2 with `ee`/K4 on the card against the same
    weights through the plain versions on the CPU, in float32."""
    rng = np.random.default_rng(4)
    n, e = 3000, 30000
    g = build_graph(None, rng.integers(0, n, e), rng.integers(0, n, e),
                    edge_attr=rng.random((e, 8)).astype(np.float32), num_nodes=n)
    n_pad = g.num_nodes_padded
    species = torch.from_numpy(np.eye(8, dtype=np.float32)[rng.integers(0, 8, n_pad)])
    nf = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32))
    co = torch.from_numpy(rng.standard_normal((n_pad, 12)).astype(np.float32))
    cfg = RevGCNConfig(hidden_channels=32, num_tasks=12, num_layers=3, group=2,
                       aggr="softmax", learn_t=True, dropout=0.0)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        model = RevGCN(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
        model.train()
        logits = model(species.to(dev), g.to(dev), node_feats=nf.to(dev))
        (logits * co.to(dev)).sum().backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    _assert_close(outs[0][0], outs[1][0], 1e-4, 1e-4)
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k, want in outs[1][1].items():
        _assert_close(outs[0][1][k], want, 1e-3, 1e-4, ref_max=g_max)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    g = _graph(cuda_device, 32)
    x = g.x
    with pytest.raises(ValueError):
        tsp.csr_seg_sum(x, g.csc_col_ptr.long(), g.csc_receivers)
    with pytest.raises(ValueError):
        tsp.csr_seg_sum(x.half(), g.csc_col_ptr, g.csc_receivers)
    with pytest.raises(ValueError):
        tsp.csr_seg_sum(x.t(), g.csc_col_ptr, g.csc_receivers)
    with pytest.raises(ValueError):
        tsp.softmax_agg(x, g.senders, g.row_ptr.cpu(), g.row_order,
                        torch.tensor([1.0], device=x.device), 1e-7)


@pytest.mark.cuda
def test_small_deeper_gcn_card_matches_cpu(cuda_device):
    """The same weights through the kernels on the card and the plain
    versions on the CPU (float32, 4 layers, learned t)."""
    rng = np.random.default_rng(2)
    n = 3000
    g = build_graph(rng.standard_normal((n, 32)).astype(np.float32),
                    rng.integers(0, n, 30000), rng.integers(0, n, 30000), num_nodes=n)
    cfg = DeeperGCNConfig(in_channels=32, hidden_channels=64, num_tasks=7, num_layers=4,
                          block="res+", aggr="softmax", learn_t=True, t=0.5, norm="batch",
                          mlp_layers=1, dropout=0.0)
    co = torch.from_numpy(rng.standard_normal((g.num_nodes_padded, 7)).astype(np.float32))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
        model.train()
        gd = g.to(dev)
        logits = model(gd.x, gd)
        (logits * co.to(dev)).sum().backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    # float32 through 4 layers: summation order in K1/K2, BatchNorm and matmuls
    _assert_close(outs[0][0], outs[1][0], 1e-4, 1e-4)
    # a bias that feeds a BatchNorm has a true gradient of 0 and returns
    # rounding noise: the floor is set by the largest gradient of all
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k, want in outs[1][1].items():
        _assert_close(outs[0][1][k], want, 1e-3, 1e-4, ref_max=g_max)


def _band_graph(dev, seed=0, n=2048, deg=8):
    """A power-law graph in a near-band layout: hub columns, hub rows and a
    leftover in both directions."""
    rng = np.random.default_rng(seed)
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.9
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-300, 301, n * deg), 0, n - 1)
    cross = rng.random(n * deg) < 0.2
    r[cross] = rng.integers(0, n, int(cross.sum()))
    x = rng.standard_normal((n, 128)).astype(np.float32)
    g = attach_band(build_graph(x, s, r, num_nodes=n), window=256, hubs=64)
    b = g.band
    assert b.fwd.hub_ids is not None and b.bwd.hub_row_ids is not None
    assert b.fwd.n_lo > 0 and b.bwd.n_lo > 0
    return g.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop,swap", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("c", [256, 128, 200, 30])
def test_band_kernel_matches_plain(cuda_device, dtype, drop, swap, c):
    """K3 against its plain version: 4-wide loads with two channel groups
    (C=256, 200) and one (128), scalar loads (30); the hash-drop plane with
    and without the id exchange."""
    g = _band_graph(cuda_device)
    band = g.band.bwd if swap else g.band.fwd
    x = torch.randn(g.num_nodes_padded, c, device=cuda_device).to(dtype)
    spec = tband.DropSpec(k0=-7, k1=123456789, thresh=tband.drop_thresh(0.3)) if drop else None
    k3 = tband.band_call.launches
    got = tband.band_call(x, band, spec, swap)
    _assert_close(got, tband.band_call_plain(x, band, spec, swap), **TOL[dtype])
    torch.cuda.synchronize()
    assert tband.band_call.launches - k3 == 1
    if drop:  # the plane really drops edges
        assert not torch.equal(got, tband.band_call(x, band))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["spmm", "softmax_sg", "learn_t"])
def test_band_functions_match_plain(cuda_device, dtype, fn):
    """band_spmm and band_softmax_agg forward and backward on the kernels
    against the same Functions on the plain versions."""
    g = _band_graph(cuda_device, seed=1)
    x = g.x.to(dtype).contiguous()
    res = []
    for plain in (False, True):
        xx = x.detach().clone().requires_grad_(True)
        tt = torch.tensor([0.1], device=cuda_device, requires_grad=fn == "learn_t")
        if fn == "spmm":
            o = (tband.band_spmm_plain if plain else tband.band_spmm)(xx, g.band)
        else:
            f = tband.band_softmax_agg_plain if plain else tband.band_softmax_agg
            o = f(xx, g.band, tt, 1e-7, fn == "learn_t")
        (o.float() ** 2).sum().backward()
        res.append((o.detach(), xx.grad, tt.grad))
    _assert_close(res[0][0], res[1][0], **TOL_BAND[dtype])
    _assert_close(res[0][1], res[1][1], **TOL_BWD[dtype])
    if fn == "learn_t":
        _assert_close(res[0][2], res[1][2], **TOL_DT[dtype])


@pytest.mark.cuda
def test_bf16_linear_on_card_matches_cpu(cuda_device):
    """The float32-accumulated bf16 product (cuBLAS bf16 x bf16 -> f32 on
    the card) and its backward against the CPU's float32 product of the
    bf16-rounded inputs."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32))
    co = torch.from_numpy(rng.standard_normal((4096, 96)).astype(np.float32))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        lin = Linear(128, 96, generator=torch.Generator().manual_seed(0)).to(dev)
        xx = x.to(dev).requires_grad_(True)
        y = lin(xx, torch.bfloat16)
        (y * co.to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, xx.grad, lin.weight.grad, lin.bias.grad)])
    # y stays float32 (summation order only); the input and weight gradients
    # round to bf16 once, so they may sit one bf16 ulp apart
    for i, (got, want) in enumerate(zip(*outs)):
        _assert_close(got, want, **(TOL[torch.float32] if i in (0, 3) else TOL[torch.bfloat16]))


# K6's el column sums terms (⟨msg, gnum⟩ + gden)·w·lrelu' whose dot is a
# warp reduction in the kernel and a torch sum in the plain version: in bf16
# a term's rounding may then flip by one ulp of the term, so the floor is one
# bf16 ulp of the largest value
TOL_GAT_EL = {torch.float32: dict(rtol=1e-5, atol_rel=1e-5),
              torch.bfloat16: dict(rtol=2.0 ** -5, atol_rel=2.0 ** -7)}


def _gat_inputs(dev, dtype, h, d, drop, seed=0, n=5000, e=60000):
    """A graph with a hub receiver row and a hub sender row (2,000 edges
    each, far more than one warp's pass) and a packed table [msg | el | 0]
    with a spread of scores; P is padded to a multiple of 8 where D is a
    multiple of 4 (the kernels' 4-wide loads), else left ragged."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n - 100, e)
    r[:2000] = 7
    s[2000:4000] = 11
    g = build_graph(None, s, r, num_nodes=n).to(dev)
    n_pad, hd = g.num_nodes_padded, h * d
    p = hd + h + ((-(hd + h)) % 8 if d % 4 == 0 else 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randn(n_pad, p, device=dev, generator=gen)
    t[:, hd:hd + h] *= 3.0
    t[:, hd + h:] = 0.0
    recv, keep_csc = g.receivers, None
    if drop:
        spec = tband.DropSpec(k0=-99, k1=31337, thresh=tband.drop_thresh(0.3))
        keep = tband.edge_keep_mask(spec, g.receivers, g.senders) > 0
        recv = torch.where(keep & g.edge_mask, g.receivers, n_pad)
        keep_csc = keep.index_select(0, g.csc_perm.long())
    return g, t.to(dtype).contiguous(), recv, keep_csc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("h,d", [(3, 256), (3, 128), (1, 40), (2, 41)])
def test_gat_kernels_match_plain(cuda_device, dtype, drop, h, d):
    """K5 and K6 against their plain versions at RevGAT's three head shapes
    (4-wide loads, two column groups per lane at D=256) and at D=41 (P=123,
    scalar loads), with and without the renormalising edge-drop; K6 also
    through the Function's backward."""
    g, t, recv, keep_csc = _gat_inputs(cuda_device, dtype, h, d, drop)
    hd = h * d
    cmax = tsp.gat_cmax(t, hd, h)
    k5, k6 = tsp.gat_fwd.launches, tsp.gat_bwd_csc.launches
    fwd_args = (g.senders, recv, g.row_ptr, cmax, hd, h, 0.2)
    out = tsp.gat_fwd(t, *fwd_args)
    _assert_close(out, tsp.gat_fwd_plain(t, *fwd_args), **TOL[dtype])
    assert not out[:, hd + h:].any()
    q = torch.randn(t.shape, device=cuda_device).to(dtype)
    bwd_args = (g.csc_col_ptr, g.csc_receivers, keep_csc, cmax, hd, h, 0.2)
    dt = tsp.gat_bwd_csc(t, q, *bwd_args)
    dt_p = tsp.gat_bwd_csc_plain(t, q, *bwd_args)
    _assert_close(dt[:, :hd], dt_p[:, :hd], **TOL[dtype])
    _assert_close(dt[:, hd:], dt_p[:, hd:], **TOL_GAT_EL[dtype])
    co = torch.randn(t.shape, device=cuda_device)
    grads = []
    for fn in (tsp.gat_softmax_spmm, tsp.gat_softmax_spmm_plain):
        tt = t.detach().clone().requires_grad_(True)
        o = fn(tt, g.senders, recv, g.row_ptr, g.csc_senders, g.csc_receivers, g.csc_col_ptr,
               keep_csc, hd, h, 0.2)
        (o.float() * co).sum().backward()
        grads.append(tt.grad)
    _assert_close(grads[0][:, :hd], grads[1][:, :hd], **TOL[dtype])
    _assert_close(grads[0][:, hd:], grads[1][:, hd:], **TOL_GAT_EL[dtype])
    torch.cuda.synchronize()
    assert (tsp.gat_fwd.launches - k5, tsp.gat_bwd_csc.launches - k6) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [False, True])
def test_small_rev_gat_card_matches_cpu(cuda_device, band):
    """A 4-layer RevGAT (2 heads, group 2, edge-drop from explicit keys,
    dropout 0) through K5/K6 (or K3/K1 on the band route) on the card
    against the same weights through the plain versions on the CPU, in
    float32: loss-weighted logits and every gradient."""
    from deep_gcns_torch_tpu_torch.models import RevGAT, RevGATConfig

    rng = np.random.default_rng(5)
    n = 3000
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.8
    rng.shuffle(w)
    s = rng.choice(n, n * 8, p=w / w.sum())
    r = np.clip(s + rng.integers(-300, 301, n * 8), 0, n - 1)
    g = build_graph(rng.standard_normal((n, 24)).astype(np.float32), s, r, num_nodes=n)
    if band:
        g = attach_band(g, window=512, hubs=64)
    co = torch.from_numpy(rng.standard_normal((g.num_nodes_padded, 6)).astype(np.float32))
    cfg = RevGATConfig(in_feats=24, n_classes=6, n_hidden=16, n_layers=4, n_heads=2, group=2,
                       dropout=0.0, input_drop=0.0, edge_drop=0.3)
    keys = ((5, -6), [(7, 8), (-9, 10)], (11, 12))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        model = RevGAT(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
        model.train()
        gd = g.to(dev)
        logits = model(gd.x, gd, drop_keys=keys)
        (logits * co.to(dev)).sum().backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    _assert_close(outs[0][0], outs[1][0], 1e-4, 1e-4)
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k, want in outs[1][1].items():
        _assert_close(outs[0][1][k], want, 1e-3, 1e-4, ref_max=g_max)


# K7–K9 (the dense destination-score GAT): M is a maximum, equal bit for
# bit; num, den, d_er, d_el and d_feat are float32 sums of terms that the
# kernel and the plain version compute alike (the same expf, the weights
# rounded to the compute type alike), so they differ in the order of the sums,
# and d_er and d_el also in the order of each per-head dot product.
TOL_DENSE = dict(rtol=1e-5, atol_rel=1e-5)
TOL_DENSE_T = dict(rtol=1e-4, atol_rel=1e-5)
# the Function in bf16: the leftover's K1 sums round to bf16, so one ulp of a
# partial sum passes into the result, as on the band route
TOL_DENSE_FN = {torch.float32: dict(rtol=1e-4, atol_rel=1e-5),
                torch.bfloat16: dict(rtol=2.0 ** -5, atol_rel=1e-4)}


def _dense_graph(dev, hubs=64, seed=0, n=3000, deg=8):
    """A locality-banded power-law graph with its band (window 512, hub
    columns and rows of degree ≥ ``hubs`` when given, a leftover)."""
    rng = np.random.default_rng(seed)
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.8
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-300, 301, n * deg), 0, n - 1)
    g = build_graph(rng.standard_normal((n, 24)).astype(np.float32), s, r, num_nodes=n)
    return attach_band(g, window=512, hubs=hubs).to(dev)


def _dense_drop(drop):
    return tband.DropSpec(k0=-99, k1=31337, thresh=tband.drop_thresh(0.3)) if drop else None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("h,d", [(3, 256), (3, 128), (1, 40), (2, 41)])
@pytest.mark.parametrize("hubs", [64, None])
def test_dense_gat_kernels_match_plain(cuda_device, dtype, drop, h, d, hubs):
    """K7, K8 and K9 against their plain versions at RevGAT's head shapes
    and at D=41 (scalar loads), with and without the hash edge-drop, on a
    band with in-kernel hub columns and on a hub-free one; m_other lifts
    every fifth receiver's stabilizer."""
    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd

    g = _dense_graph(cuda_device, hubs)
    band, bwd = g.band.fwd, g.band.bwd
    assert (band.hub_ids is not None) == (hubs is not None)
    spec = _dense_drop(drop)
    n = g.num_nodes_padded
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    feat = torch.randn(n, h * d, device=cuda_device, generator=gen).to(dtype)
    el = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    er = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    m_other = torch.full((n, h), tgd.NEG, device=cuda_device)
    m_other[::5] = 3.0
    launches = [k.launches for k in (tgd.win_fused, tgd.win_der, tgd.win_dsend)]
    num, den, m = tgd.win_fused(band, el, er, m_other, feat, 0.2, spec)
    num_p, den_p, m_p = tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec)
    assert torch.equal(m, m_p)
    _assert_close(num, num_p, **TOL_DENSE)
    _assert_close(den, den_p, **TOL_DENSE)
    gnum = torch.randn(n, h * d, device=cuda_device, generator=gen).to(dtype)
    gden = torch.randn(n, h, device=cuda_device, generator=gen)
    args = (el, er, m_p, feat, gnum, gden, 0.2, spec)
    _assert_close(tgd.win_der(band, *args), tgd.win_der_plain(band, *args), **TOL_DENSE_T)
    d_el, d_feat = tgd.win_dsend(bwd, *args)
    d_el_p, d_feat_p = tgd.win_dsend_plain(bwd, *args)
    _assert_close(d_el, d_el_p, **TOL_DENSE_T)
    _assert_close(d_feat, d_feat_p, **TOL_DENSE)
    torch.cuda.synchronize()
    assert [k.launches for k in (tgd.win_fused, tgd.win_der, tgd.win_dsend)] == [
        v + 1 for v in launches]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop", [False, True])
def test_dense_gat_function_matches_plain(cuda_device, dtype, drop):
    """`gat_dense_agg` on K7–K9 and K1 against the same Function on the
    plain versions: num, den and the gradients of feat, el and er."""
    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd

    g = _dense_graph(cuda_device)
    n, h, d = g.num_nodes_padded, 3, 32
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    feat = torch.randn(n, h, d, device=cuda_device, generator=gen)
    el = torch.randn(n, h, device=cuda_device, generator=gen)
    er = torch.randn(n, h, device=cuda_device, generator=gen)
    co_n = torch.randn(n, h, d, device=cuda_device, generator=gen)
    co_d = torch.randn(n, h, device=cuda_device, generator=gen)
    res = []
    for fn in (tgd.gat_dense_agg, tgd.gat_dense_agg_plain):
        f, l, r = (t.clone().requires_grad_(True) for t in (feat, el, er))
        num, den = fn(f, l, r, None, None, None, g.band, _dense_drop(drop), 0.2, dtype)
        ((num * co_n).sum() + (den * co_d).sum()).backward()
        res.append((num.detach(), den.detach(), f.grad, l.grad, r.grad))
    for name, a, b in zip(("num", "den", "d_feat", "d_el", "d_er"), *res):
        _assert_close(a, b, **TOL_DENSE_FN[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [dict(use_attn_dst=True), dict(stabilizer="per_receiver")])
def test_small_rev_gat_dense_card_matches_cpu(cuda_device, variant):
    """A 4-layer RevGAT on the band's dense route (destination scores, or the
    per-receiver stabilizer) through K7–K9 and K1 on the card against the
    same weights through the plain versions on the CPU, float32."""
    from deep_gcns_torch_tpu_torch.models import RevGAT, RevGATConfig

    g = _dense_graph(torch.device("cpu"), seed=6)
    co = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (g.num_nodes_padded, 6)).astype(np.float32))
    cfg = RevGATConfig(in_feats=24, n_classes=6, n_hidden=16, n_layers=4, n_heads=2, group=2,
                       dropout=0.0, input_drop=0.0, edge_drop=0.3, **variant)
    keys = ((5, -6), [(7, 8), (-9, 10)], (11, 12))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        model = RevGAT(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
        model.train()
        gd = g.to(dev)
        logits = model(gd.x, gd, drop_keys=keys)
        (logits * co.to(dev)).sum().backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    _assert_close(outs[0][0], outs[1][0], 1e-4, 1e-4)
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k, want in outs[1][1].items():
        _assert_close(outs[0][1][k], want, 1e-3, 1e-4, ref_max=g_max)


@pytest.mark.cuda
def test_pyg_gatconv_dense_card_matches_cpu(cuda_device):
    """PyG's GATConv with explicit self edges on the dense route (the
    analytic self term) on the card against the CPU, float32."""
    from deep_gcns_torch_tpu_torch.convs.sparse import GATConv

    rng = np.random.default_rng(8)
    n = 3000
    s = rng.integers(0, n, n * 6)
    r = np.clip(s + rng.integers(-200, 201, n * 6), 0, n - 1)
    ids = rng.choice(n, n // 3, replace=False)
    s, r = np.concatenate([s, ids]), np.concatenate([r, ids])
    g = attach_band(build_graph(rng.standard_normal((n, 24)).astype(np.float32), s, r,
                                num_nodes=n), window=512)
    co = torch.from_numpy(rng.standard_normal((g.num_nodes_padded, 32)).astype(np.float32))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        conv = GATConv(24, 8, heads=4, generator=torch.Generator().manual_seed(0)).to(dev)
        gd = g.to(dev)
        x = gd.x.clone().requires_grad_(True)
        out = conv(x, gd)
        (out * co.to(dev)).sum().backward()
        outs.append([out.detach().cpu(), x.grad.cpu()]
                    + [p.grad.cpu() for p in conv.parameters()])
    for a, b in zip(*outs):
        _assert_close(a, b, 1e-4, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 40, 1])
def test_block_spmm_matches_plain(cuda_device, dtype, c):
    """K10 forward (tiles) and through the Function's backward (transpose
    tiles) against the plain version: f32 sums in the same order as the
    plain version on the card up to its `index_add_` order, bf16 one ulp of
    the final rounding. Receiver block 0 has no edge and comes out 0."""
    from deep_gcns_torch_tpu_torch.ops import blocksparse as tbs

    rng = np.random.default_rng(9)
    n = 40 * tbs.BN
    s = rng.integers(0, n, n * 12)
    r = np.clip(s + rng.integers(-300, 301, n * 12), tbs.BN, n - 1)
    tiles, tiles_t = (t.to(cuda_device) for t in tbs.build_block_tiles(s, r, n))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(n, c, device=cuda_device, generator=gen).to(dtype)
    co = torch.randn(n, c, device=cuda_device, generator=gen).to(dtype)
    tol = TOL[dtype]
    before = tbs.block_spmm.launches
    res = []
    for fn in (tbs.block_spmm, tbs.block_spmm_plain):
        xx = x.clone().requires_grad_(True)
        out = fn(xx, tiles, tiles_t)
        out.backward(co)
        res.append((out.detach(), xx.grad))
    torch.cuda.synchronize()
    assert tbs.block_spmm.launches == before + 2
    assert bool((res[0][0][:tbs.BN] == 0).all())
    _assert_close(res[0][0], res[1][0], **tol)
    _assert_close(res[0][1], res[1][1], **tol)


def _bsp_corner_graph(n_blocks=40, seed=11):
    """A banded graph whose first and last receiver blocks have no edge, with
    one (r, s) edge 300 times in a tile beside others (a count above bf16's
    exact 256) and one 520 times (a full tile of 512 copies, then 8 more)."""
    from deep_gcns_torch_tpu_torch.ops import blocksparse as tbs

    rng = np.random.default_rng(seed)
    n = n_blocks * tbs.BN
    s = rng.integers(0, n, n * 12)
    r = np.clip(s + rng.integers(-300, 301, n * 12), tbs.BN, n - tbs.BN - 1)
    s = np.concatenate([s, np.full(300, 3 * tbs.BN + 7), np.full(520, 9 * tbs.BN + 100)])
    r = np.concatenate([r, np.full(300, 2 * tbs.BN + 5), np.full(520, 9 * tbs.BN + 1)])
    return n, s, r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 40, 3])
def test_block_spmm_corner_cases(cuda_device, dtype, c):
    """K10's tensor-core form on its corner cases: the 300-fold and 520-fold
    cells exact against the plain version (integer-valued x, so every float32
    sum is exact and both round the same value once), random x within the
    tolerance, the empty first and last receiver blocks exact 0, and two
    launches bit for bit the same."""
    from deep_gcns_torch_tpu_torch.ops import blocksparse as tbs

    n, s, r = _bsp_corner_graph()
    tiles, tiles_t = (t.to(cuda_device) for t in tbs.build_block_tiles(s, r, n))
    counts = np.unique(r * n + s, return_counts=True)[1]
    assert counts.max() >= 520 and ((counts >= 300) & (counts < 512)).any()
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    xi = torch.randint(-8, 9, (n, c), device=cuda_device, generator=gen).to(dtype)
    for tl in (tiles, tiles_t):
        got = tbs.bsp_call(xi, tl)
        assert torch.equal(got, tbs.bsp_call_plain(xi, tl))
    x = torch.randn(n, c, device=cuda_device, generator=gen).to(dtype)
    out = tbs.bsp_call(x, tiles)
    _assert_close(out, tbs.bsp_call_plain(x, tiles), **TOL[dtype])
    _assert_close(tbs.bsp_call(x, tiles_t), tbs.bsp_call_plain(x, tiles_t), **TOL[dtype])
    assert bool((out[:tbs.BN] == 0).all()) and bool((out[-tbs.BN:] == 0).all())
    assert torch.equal(out, tbs.bsp_call(x, tiles))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_block_spmm_wide_rows_chunk(cuda_device):
    """C > 128 runs in chunks of 128 channels across thread blocks."""
    from deep_gcns_torch_tpu_torch.ops import blocksparse as tbs

    n, s, r = _bsp_corner_graph(n_blocks=12, seed=12)
    tiles, _ = (t.to(cuda_device) for t in tbs.build_block_tiles(s, r, n))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, 200, device=cuda_device, generator=gen).to(dtype)
        _assert_close(tbs.bsp_call(x, tiles), tbs.bsp_call_plain(x, tiles), **TOL[dtype])


def _k2_corner_graph(dev, seed=13, n=3000, e=30000, hub=5000):
    """Random edges with 8-dim edge features, a hub row of ``hub`` in-edges
    (row 11) and rows with no edge (the last 100 nodes receive none)."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n - 100, e)
    r[:hub] = 11
    ea = rng.random((e, 8)).astype(np.float32)
    return build_graph(None, s, r, edge_attr=ea, num_nodes=n).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 64, 128, 41])
@pytest.mark.parametrize("with_ee", [False, True])
def test_softmax_agg_lane_groups(cuda_device, dtype, c, with_ee):
    """K2's lane groups against the plain version, with and without edge
    embeddings: C=40, 64 and 128 (3, 2 and 1 lane groups in bf16, one in
    float32), C=41 (the scalar form), a hub row of 5,000 edges, rows with no
    edge (out and lse exact 0), and two launches bit for bit the same."""
    g = _k2_corner_graph(cuda_device)
    x, ee, _ = _edge_inputs(g, c, dtype, seed=4)
    ee = ee if with_ee else None
    t = torch.tensor([0.7], device=cuda_device)
    before = (tsp.softmax_agg.launches, tsp.softmax_agg.launches_ee)
    out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    out_p, lse_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    _assert_close(out, out_p, **TOL[dtype])
    _assert_close(lse, lse_p, **TOL_LSE)
    empty = (g.row_ptr[1:] == g.row_ptr[:-1]).nonzero()[:, 0]
    assert empty.numel() >= 100
    assert not out[empty].any() and not lse[empty].any()
    out2, lse2 = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    torch.cuda.synchronize()
    after = (tsp.softmax_agg.launches, tsp.softmax_agg.launches_ee)
    assert (after[0] - before[0], after[1] - before[1]) == ((0, 2) if with_ee else (2, 0))


def _k4_corner_graph(dev, seed=17, n=3000, e=30000, hub=4000):
    """Random edges with 8-dim edge features, a hub SENDER of ``hub``
    out-edges (node 17, one row of K4's CSC walk) and senders with no edge
    (the last 100 nodes send none)."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n - 100, e), rng.integers(0, n, e)
    s[:hub] = 17
    ea = rng.random((e, 8)).astype(np.float32)
    return build_graph(None, s, r, edge_attr=ea, num_nodes=n).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 64, 128, 41])
@pytest.mark.parametrize("grad_weights", [False, True])
def test_softmax_bwd_csc_lane_groups(cuda_device, dtype, c, grad_weights):
    """K4's lane groups against the plain version: C=40, 64 and 128 (3, 2
    and 1 lane groups in bf16, one in float32), C=41 (the scalar form), a
    hub sender of 4,000 edges, senders with no edge (dx exact 0), dee's
    padding rows exact 0, and two launches bit for bit the same (dt too)."""
    g = _k4_corner_graph(cuda_device)
    x, ee, ee_csc = _edge_inputs(g, c, dtype, seed=5)
    t = torch.tensor([0.7], device=cuda_device)
    _, lse = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q = torch.randn(g.num_nodes_padded, c, device=cuda_device, generator=gen).to(dtype)
    if grad_weights:
        out = torch.randn(g.num_nodes_padded, c, device=cuda_device, generator=gen).to(dtype)
        q = torch.cat([q, out], 1).contiguous()
    args = (x, ee_csc, q, lse, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, grad_weights)
    before = tsp.softmax_bwd_csc.launches
    dx, dee, dt = tsp.softmax_bwd_csc(*args)
    dx_p, dee_p, dt_p = tsp.softmax_bwd_csc_plain(*args)
    _assert_close(dx, dx_p, **TOL[dtype])
    _assert_close(dee, dee_p, **TOL[dtype])
    ptr = g.csc_col_ptr
    assert int((ptr[18] - ptr[17])) >= 4000
    no_edge = (ptr[1:] == ptr[:-1]).nonzero()[:, 0]
    assert no_edge.numel() >= 100 and not dx[no_edge].any()
    assert not dee[g.n_edge:].any()
    dx2, dee2, dt2 = tsp.softmax_bwd_csc(*args)
    assert torch.equal(dx, dx2) and torch.equal(dee, dee2)
    if grad_weights:
        _assert_close(dt, dt_p, **TOL_DT[torch.float32])
        assert torch.equal(dt, dt2)
    torch.cuda.synchronize()
    assert tsp.softmax_bwd_csc.launches == before + 2


def _long_row_band(dev, hubs=True, seed=21, n=4096, deg=8):
    """A band whose rows reach and pass K7's list: locality-banded power-law
    senders, window 768 and no hub rows (receiver 5 takes 700 senders of its
    window, 300 takes 400 and 700 exactly 256), with the hub columns of a
    second band (degree ≥ 64) attached when ``hubs``, so that a long row's
    chunks run on into its hub columns. A few receivers have no position."""
    import dataclasses

    rng = np.random.default_rng(seed)
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.8
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-200, 201, n * deg), 0, n - 1)
    hub_band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=64).band.fwd
    s = np.concatenate([s, np.arange(0, 700), np.arange(100, 500), np.arange(500, 756)])
    r = np.concatenate([r, np.full(700, 5), np.full(400, 300), np.full(256, 700)])
    band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=None).band.fwd
    if hubs:
        band = dataclasses.replace(band, hub_ids=hub_band.hub_ids, a_hub=hub_band.a_hub)
    return band.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(3, 128), (3, 256), (1, 40)])
def test_win_fused_long_rows(cuda_device, dtype, h, d):
    """K7 on rows at and past its list (`k7_list_size`), with hub columns and
    with and without the drop, against its plain version: M bit for bit,
    num and den within float32's summation order, two launches bit for bit,
    one launch each."""
    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd

    band = _long_row_band(cuda_device)
    kept = (band.a > 0).sum(1) + (band.a_hub > 0).sum(1)
    assert int(kept.max()) >= 2 * tgd.k7_list_size(h) and tgd._hub_in_kernel(band)
    n = band.a.shape[0]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    feat = torch.randn(n, h * d, device=cuda_device, generator=gen).to(dtype)
    el = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    er = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    m_other = torch.full((n, h), tgd.NEG, device=cuda_device)
    m_other[::5] = 3.0
    for drop in (False, True):
        spec = _dense_drop(drop)
        before = tgd.win_fused.launches
        num, den, m = tgd.win_fused(band, el, er, m_other, feat, 0.2, spec)
        num_p, den_p, m_p = tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec)
        assert torch.equal(m, m_p)
        _assert_close(num, num_p, **TOL_DENSE)
        _assert_close(den, den_p, **TOL_DENSE)
        for a, b in zip(tgd.win_fused(band, el, er, m_other, feat, 0.2, spec), (num, den, m)):
            assert torch.equal(a, b)
        torch.cuda.synchronize()
        assert tgd.win_fused.launches == before + 2


def _k9_long_row_band(dev, hubs=True, seed=21, n=4096, deg=8):
    """The mirror of `_long_row_band` for K9: a TRANSPOSE band whose sender
    rows reach and pass K9's list (sender 5 sends to 700 receivers of its
    window, 300 to 400 and 700 to exactly 256), window 768 and no hub rows,
    with the transpose hub columns of a second band (degree ≥ 64) attached
    when ``hubs``, so that a long row's chunks run on into its hub columns.
    The power-law senders leave many rows with no position at all."""
    import dataclasses

    rng = np.random.default_rng(seed)
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.8
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-200, 201, n * deg), 0, n - 1)
    hub_band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=64).band.bwd
    s = np.concatenate([s, np.full(700, 5), np.full(400, 300), np.full(256, 700)])
    r = np.concatenate([r, np.arange(0, 700), np.arange(100, 500), np.arange(500, 756)])
    band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=None).band.bwd
    if hubs:
        band = dataclasses.replace(band, hub_ids=hub_band.hub_ids, a_hub=hub_band.a_hub)
    return band.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(3, 128), (3, 256), (1, 40), (2, 41)])
@pytest.mark.parametrize("hubs", [True, False])
def test_win_dsend_long_rows(cuda_device, dtype, h, d, hubs):
    """K9 on sender rows at and past its list (`k9_list_size`), with and
    without hub columns and the drop, against its plain version: d_el within
    TOL_DENSE_T (its per-head dot is regrouped as feat·Σ a·gnum), d_feat
    within TOL_DENSE, rows with no kept position exactly 0, two launches bit
    for bit, one launch each."""
    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd

    band = _k9_long_row_band(cuda_device, hubs)
    kept = (band.a > 0).sum(1)
    if hubs:
        kept = kept + (band.a_hub > 0).sum(1)
        assert tgd._hub_in_kernel(band)
    assert int(kept.max()) >= 2 * tgd.k9_list_size(h)
    n = band.a.shape[0]
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    feat = torch.randn(n, h * d, device=cuda_device, generator=gen).to(dtype)
    gnum = torch.randn(n, h * d, device=cuda_device, generator=gen).to(dtype)
    el = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    er = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    gden = torch.randn(n, h, device=cuda_device, generator=gen)
    m = torch.full((n, h), 3.0, device=cuda_device)
    m[::3] = 6.0
    for drop in (False, True):
        spec = _dense_drop(drop)
        args = (el, er, m, feat, gnum, gden, 0.2, spec)
        before = tgd.win_dsend.launches
        d_el, d_feat = tgd.win_dsend(band, *args)
        d_el_p, d_feat_p = tgd.win_dsend_plain(band, *args)
        _assert_close(d_el, d_el_p, **TOL_DENSE_T)
        _assert_close(d_feat, d_feat_p, **TOL_DENSE)
        empty = torch.ones(n, dtype=torch.bool, device=cuda_device)
        empty[tgd._entries(band, spec, True)[0]] = False
        assert int(empty.sum()) > 0
        assert not d_el[empty].any() and not d_feat[empty].any()
        for a, b in zip(tgd.win_dsend(band, *args), (d_el, d_feat)):
            assert torch.equal(a, b)
        torch.cuda.synchronize()
        assert tgd.win_dsend.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(3, 256), (3, 128), (1, 40), (2, 41)])
def test_gat_fwd_corner_cases(cuda_device, dtype, h, d):
    """K5 against its plain version on a receiver of 4,500 edges (141 slot
    batches of a warp's edge table), 40 receivers whose every edge is
    dropped and 100 with no edge (num, den and the padding columns exactly
    0), at P=776, 392 and 48 (lane groups in bf16) and at D=41 (P=123,
    scalar loads); two launches bit for bit, one launch each."""
    n, e = 5000, 40000
    rng = np.random.default_rng(19)
    s, r = rng.integers(0, n, e), rng.integers(0, n - 100, e)
    r[:4500] = 7
    g = build_graph(None, s, r, num_nodes=n).to(cuda_device)
    n_pad, hd = g.num_nodes_padded, h * d
    p = hd + h + ((-(hd + h)) % 8 if d % 4 == 0 else 0)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    t = torch.randn(n_pad, p, device=cuda_device, generator=gen)
    t[:, hd:hd + h] *= 3.0
    t[:, hd + h:] = 0.0
    t = t.to(dtype).contiguous()
    dropped = (g.receivers >= 20) & (g.receivers < 60)
    recv = torch.where(dropped | ~g.edge_mask, n_pad, g.receivers).contiguous()
    cmax = tsp.gat_cmax(t, hd, h)
    args = (g.senders, recv, g.row_ptr, cmax, hd, h, 0.2)
    before = tsp.gat_fwd.launches
    out = tsp.gat_fwd(t, *args)
    _assert_close(out, tsp.gat_fwd_plain(t, *args), **TOL[dtype])
    assert int((g.row_ptr[8] - g.row_ptr[7]).item()) >= 4500
    assert not out[20:60].any() and not out[n - 100:].any() and not out[:, hd + h:].any()
    assert out[7, :hd + h].abs().sum() > 0
    assert torch.equal(tsp.gat_fwd(t, *args), out)
    torch.cuda.synchronize()
    assert tsp.gat_fwd.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(3, 128), (3, 256), (1, 40), (2, 41), (8, 16)])
@pytest.mark.parametrize("hubs", [True, False])
def test_win_der_long_rows(cuda_device, dtype, h, d, hubs):
    """K8 on receiver rows at and past its list (`k8_list_size`), with and
    without hub columns and the drop, against its plain version: d_er within
    TOL_DENSE_T (its per-head dot is regrouped as gnum·Σ a·feat), rows with
    no kept position exactly 0, two launches bit for bit, one launch each;
    3 x 256 walks its 768 columns in chunks, D=41 takes scalar loads, 8 x 16
    puts eight heads in one column group of the walk."""
    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd

    band = _long_row_band(cuda_device, hubs)
    kept = (band.a > 0).sum(1)
    if hubs:
        kept = kept + (band.a_hub > 0).sum(1)
        assert tgd._hub_in_kernel(band)
    assert int(kept.max()) >= 2 * tgd.k8_list_size(h)
    n = band.a.shape[0]
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    feat = torch.randn(n, h * d, device=cuda_device, generator=gen).to(dtype)
    gnum = torch.randn(n, h * d, device=cuda_device, generator=gen).to(dtype)
    el = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    er = torch.randn(n, h, device=cuda_device, generator=gen) * 2
    gden = torch.randn(n, h, device=cuda_device, generator=gen)
    m = torch.full((n, h), 3.0, device=cuda_device)
    m[::3] = 6.0
    for drop in (False, True):
        spec = _dense_drop(drop)
        args = (el, er, m, feat, gnum, gden, 0.2, spec)
        before = tgd.win_der.launches
        d_er = tgd.win_der(band, *args)
        _assert_close(d_er, tgd.win_der_plain(band, *args), **TOL_DENSE_T)
        empty = torch.ones(n, dtype=torch.bool, device=cuda_device)
        empty[tgd._entries(band, spec, False)[0]] = False
        assert int(empty.sum()) > 0 and not d_er[empty].any()
        assert torch.equal(tgd.win_der(band, *args), d_er)
        torch.cuda.synchronize()
        assert tgd.win_der.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(3, 256), (3, 128), (1, 40), (2, 41), (8, 16), (4, 12)])
@pytest.mark.parametrize("keep", [False, True])
def test_gat_bwd_csc_corner_cases(cuda_device, dtype, h, d, keep):
    """K6 against its plain version on a sender of 4,500 CSC edges (141 slot
    batches of a warp's edge table), 40 senders whose every edge `keep_csc`
    drops (with the hash keep of the other edges) and 100 with no edge (dT's
    row and the padding columns exactly 0), at P=776 (one walk of 6 column
    groups), 392, 48 (lane groups in bf16), at D=41 (P=123, scalar loads),
    8 x 16 (six heads a walk, several in one column group: the per-lane head
    slots) and 4 x 12 (lane groups of four one-head walks in bf16), with and
    without `keep_csc`; two launches bit for bit, one launch each."""
    n, e = 5000, 40000
    rng = np.random.default_rng(31)
    s, r = rng.integers(0, n - 100, e), rng.integers(0, n, e)
    s[:4500] = 7
    g = build_graph(None, s, r, num_nodes=n).to(cuda_device)
    assert int((g.csc_col_ptr[8] - g.csc_col_ptr[7]).item()) >= 4500
    n_pad, hd = g.num_nodes_padded, h * d
    keep_csc = None
    if keep:
        spec = tband.DropSpec(k0=-77, k1=4242, thresh=tband.drop_thresh(0.3))
        hashed = (tband.edge_keep_mask(spec, g.receivers, g.senders) > 0).index_select(
            0, g.csc_perm.long())
        keep_csc = hashed & ~((g.csc_senders >= 20) & (g.csc_senders < 60))
    p = hd + h + ((-(hd + h)) % 8 if d % 4 == 0 else 0)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    t = torch.randn(n_pad, p, device=cuda_device, generator=gen)
    t[:, hd:hd + h] *= 3.0
    t[:, hd + h:] = 0.0
    t = t.to(dtype).contiguous()
    q = torch.randn(n_pad, p, device=cuda_device, generator=gen).to(dtype)
    args = (g.csc_col_ptr, g.csc_receivers, keep_csc, tsp.gat_cmax(t, hd, h), hd, h, 0.2)
    before = tsp.gat_bwd_csc.launches
    dt = tsp.gat_bwd_csc(t, q, *args)
    want = tsp.gat_bwd_csc_plain(t, q, *args)
    _assert_close(dt[:, :hd], want[:, :hd], **TOL[dtype])
    _assert_close(dt[:, hd:], want[:, hd:], **TOL_GAT_EL[dtype])
    assert not dt[n - 100:].any() and not dt[:, hd + h:].any()
    assert dt[7, :hd + h].abs().sum() > 0
    if keep:
        assert not dt[20:60].any()
    assert torch.equal(tsp.gat_bwd_csc(t, q, *args), dt)
    torch.cuda.synchronize()
    assert tsp.gat_bwd_csc.launches == before + 2


def _k1_corner_graph(dev):
    """3,000 nodes: a receiver of 5,000 edges and a sender of 5,000 (hub rows
    of both forms), the last 100 nodes with no edge either way, and the edge
    arrays padded with the sentinel N_pad, which K1 must never read."""
    n, e = 3000, 30000
    rng = np.random.default_rng(41)
    s, r = rng.integers(0, n - 100, e), rng.integers(0, n - 100, e)
    r[:5000] = 7
    s[5000:10000] = 11
    g = build_graph(None, s, r, num_nodes=n).to(dev)
    assert int((g.row_ptr[8] - g.row_ptr[7]).item()) >= 5000
    assert int((g.csc_col_ptr[12] - g.csc_col_ptr[11]).item()) >= 5000
    assert g.num_edges_padded > e and int(g.csc_receivers[e:].min()) == g.num_nodes_padded
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 30, 48, 128, 392, 776])
def test_seg_sum_corner_cases(cuda_device, dtype, c):
    """K1 in both forms on `_k1_corner_graph` at every layout it takes: C=8
    (lane groups: 16 rows a warp of 2 lanes in f32, 32 of one lane with
    16-byte loads in bf16), 30 (scalar loads, one warp a row), 48 (2 rows a
    warp of 12 lanes in f32, 5 of 6 in bf16), 128 (one warp a row in f32, 2
    rows a warp of 16 lanes in bf16), 392 and 776 (one walk over 4 and 7
    slots a lane): against the plain version within TOL, rows with no edge
    exactly 0, two launches bit for bit, one launch each."""
    g = _k1_corner_graph(cuda_device)
    n_pad = g.num_nodes_padded
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    msgs = torch.randn(g.num_edges_padded, c, device=cuda_device, generator=gen).to(dtype)
    src = torch.randn(n_pad, c, device=cuda_device, generator=gen).to(dtype)
    before = tsp.csr_seg_sum.launches
    for args in ((msgs, g.row_ptr), (src, g.csc_col_ptr, g.csc_receivers)):
        out = tsp.csr_seg_sum(*args)
        _assert_close(out, tsp.csr_seg_sum_plain(*args), **TOL[dtype])
        assert not out[2900:].any()
        assert out[7].abs().sum() > 0 and out[11].abs().sum() > 0
        assert torch.equal(tsp.csr_seg_sum(*args), out)
    torch.cuda.synchronize()
    assert tsp.csr_seg_sum.launches == before + 4


def _mol_batch(dev, batch=32, seed=0):
    """A batch of the ogbg-mol app's synthetic molecules (10-29 atoms, 3n
    bonds) with its fixed pads: N_pad 1024, E_pad 3072 at 32 molecules."""
    import argparse

    from deep_gcns_torch_tpu_torch.apps import ogbg_mol

    args = argparse.Namespace(synthetic=True, num_tasks=1)
    train, test = ogbg_mol.load_mol(args, np.random.default_rng(seed))
    g, y = ogbg_mol.make_batcher(batch, train + test)(train[:batch])
    return g.to(dev), y.to(dev)


def _ogb_inputs(dev, shape):
    """(graph, x, ee, ee_csc) at one of the OGB apps' kernel shapes: the
    molecule batch's BondEncoder output (a sum of embedding rows; padded
    edges carry attribute 0, so real rows) at C=256 and C=128, or the
    ogbl-collab SBM without edge embeddings at C=64, float32 as the apps
    run."""
    from deep_gcns_torch_tpu_torch.data.synthetic import sbm_arxiv_like
    from deep_gcns_torch_tpu_torch.nn.core import MultiEmbedding

    kind, c = shape
    gen = torch.Generator(device=dev).manual_seed(c)
    if kind == "mol":
        g, _ = _mol_batch(dev)
        enc = MultiEmbedding((5, 6, 2), c, generator=torch.Generator().manual_seed(c)).to(dev)
        with torch.no_grad():
            ee, ee_csc = enc(g.edge_attr), enc(g.edge_attr_csc)
        x = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen)
        return g, x, ee.contiguous(), ee_csc.contiguous()
    g, _ = sbm_arxiv_like(np.random.default_rng(0), n=20000, num_classes=8, c=64, avg_degree=8)
    g = g.to(dev)
    return g, torch.randn(g.num_nodes_padded, c, device=dev, generator=gen), None, None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [("mol", 256), ("mol", 128), ("collab", 64)])
def test_ogb_kernel_shapes_match_plain(cuda_device, shape):
    """The shapes the OGB apps give the kernels, in float32: K2 with `ee`
    and K4 with and without dt at C=256 (ogbg-mol's BondEncoder in every
    layer) and C=128 (ogbg-ppa) on a 32-molecule batch (N_pad 1024, E_pad
    3072, padded edges outside every range: their d(ee) rows exact 0), and
    K2 and K1's gathered form at C=64 (ogbl-collab) without edge
    embeddings, K4's gather form there (no d(ee))."""
    g, x, ee, ee_csc = _ogb_inputs(cuda_device, shape)
    tol = TOL[torch.float32]
    t = torch.tensor([1.0], device=cuda_device)
    out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    out_p, lse_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    _assert_close(out, out_p, **tol)
    _assert_close(lse, lse_p, **TOL_LSE)
    q = torch.randn(g.num_nodes_padded, x.shape[1], device=cuda_device)
    for gw in (False, True):
        qo = torch.cat([q, out_p], 1).contiguous() if gw else q
        args = (x, ee_csc, qo, lse_p, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, gw)
        dx, dee, dt = tsp.softmax_bwd_csc(*args)
        dx_p, dee_p, dt_p = tsp.softmax_bwd_csc_plain(*args)
        _assert_close(dx, dx_p, **tol)
        if ee is None:
            assert dee is None and dee_p is None
        else:
            _assert_close(dee, dee_p, **tol)
            assert not dee[g.n_edge:].any()
        if gw:
            _assert_close(dt, dt_p, **TOL_DT[torch.float32])


def _card_and_cpu(dev, build, run):
    """(outputs, gradients by name) of ``run(model, device)`` on the card
    and on the CPU from the same weights (``build()`` seeded)."""
    outs = []
    for d in (dev, torch.device("cpu")):
        model = build().to(d)
        model.train()
        out = run(model, d)
        outs.append((out.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    return outs


def _assert_card_matches_cpu(outs):
    # float32 through a few layers: summation order in the kernels, BatchNorm
    # and matmuls; gradients above a floor set by the largest gradient
    _assert_close(outs[0][0], outs[1][0], 1e-4, 1e-4)
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k, want in outs[1][1].items():
        _assert_close(outs[0][1][k], want, 1e-3, 1e-4, ref_max=g_max)


@pytest.mark.cuda
def test_small_mol_card_matches_cpu(cuda_device):
    """A 3-layer ogbg-mol DeeperGCN (AtomEncoder, a BondEncoder in every
    layer, learned t, the virtual node, mean pooling, C=64) on a
    32-molecule batch: the kernels on the card against the plain versions
    on the CPU, the logits and every gradient (the embedding tables' too)."""
    from deep_gcns_torch_tpu_torch.data.ogb_features import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS

    g, y = _mol_batch(torch.device("cpu"))
    cfg = DeeperGCNConfig(in_channels=0, hidden_channels=64, num_tasks=1, num_layers=3,
                          aggr="softmax", learn_t=True, node_encoder="atom",
                          atom_feature_dims=ATOM_FEATURE_DIMS, edge_mode="bond",
                          bond_feature_dims=BOND_FEATURE_DIMS, add_virtual_node=True,
                          graph_pooling="mean", final_relu=False)

    def run(model, d):
        gd = g.to(d)
        logits = model(gd.x, gd)
        logits.sum().backward()
        return logits

    _assert_card_matches_cpu(_card_and_cpu(
        cuda_device, lambda: DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)), run))


@pytest.mark.cuda
def test_small_collab_card_matches_cpu(cuda_device):
    """The ogbl-collab objective (3-layer encoder at C=64 and the
    LinkPredictor, pos/neg log loss) on the card against the CPU: the loss
    and every gradient of both models."""
    from deep_gcns_torch_tpu_torch.apps import ogbl_collab

    args = ogbl_collab.get_args(["--synthetic", "--synthetic_nodes", "3000"])
    g, train_pos, _, n, in_dim = ogbl_collab.load_data(args, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    sel = rng.integers(0, len(train_pos[0]), 1024)
    pos = (torch.from_numpy(train_pos[0][sel]), torch.from_numpy(train_pos[1][sel]))
    neg = (torch.from_numpy(rng.integers(0, n, 1024)), torch.from_numpy(rng.integers(0, n, 1024)))

    def run(models, d):
        gd = g.to(d)
        h = models["model"](gd.x, gd)
        p = models["predictor"](h[pos[0].to(d)], h[pos[1].to(d)])
        q = models["predictor"](h[neg[0].to(d)], h[neg[1].to(d)])
        loss = -torch.log(p + 1e-15).mean() - torch.log(1 - q + 1e-15).mean()
        loss.backward()
        return loss

    _assert_card_matches_cpu(_card_and_cpu(
        cuda_device,
        lambda: ogbl_collab.build_models(args, in_dim, torch.Generator().manual_seed(0)), run))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 64, 128, 256, 41])
def test_softmax_agg_msgs_matches_plain(cuda_device, dtype, c):
    """K2's message form against its plain version on the corner graph (a
    hub row of 5,000 edges, rows with no edge exact 0), messages of either
    sign with each row's exact shift, two launches bit for bit; counted
    apart from the gather forms."""
    g = _k2_corner_graph(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    msgs = torch.randn(g.num_edges_padded, c, device=cuda_device, generator=gen).to(dtype)
    t = torch.tensor([0.7], device=cuda_device)
    before = (tsp.softmax_agg_msgs.launches, tsp.softmax_agg.launches)
    out, lse = tsp.softmax_agg_msgs(msgs, g.row_ptr, t)
    out_p, lse_p = tsp.softmax_agg_msgs_plain(msgs, g.row_ptr, t)
    _assert_close(out, out_p, **TOL[dtype])
    _assert_close(lse, lse_p, **TOL_LSE)
    empty = (g.row_ptr[1:] == g.row_ptr[:-1]).nonzero()[:, 0]
    assert empty.numel() >= 100
    assert not out[empty].any() and not lse[empty].any()
    out2, lse2 = tsp.softmax_agg_msgs(msgs, g.row_ptr, t)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    torch.cuda.synchronize()
    assert (tsp.softmax_agg_msgs.launches - before[0],
            tsp.softmax_agg.launches - before[1]) == (2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_weights", [False, True])
def test_message_form_function_matches_plain(cuda_device, dtype, grad_weights):
    """`gen_softmax_aggregate_csr` on the card (the message form forward)
    against the Function on the plain version: out, d(msgs) and dt."""
    g = _graph(cuda_device, 64, seed=2)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    msgs = torch.randn(g.num_edges_padded, 64, device=cuda_device, generator=gen).to(dtype)
    res = []
    for fn in (tsp.gen_softmax_aggregate_csr, tsp.gen_softmax_aggregate_csr_plain):
        m = msgs.detach().clone().requires_grad_(True)
        tt = torch.tensor([0.4], device=cuda_device, requires_grad=grad_weights)
        o = fn(m, g.receivers, g.row_ptr, tt, grad_weights)
        (o.float() ** 2).sum().backward()
        res.append((o.detach(), m.grad, tt.grad))
    _assert_close(res[0][0], res[1][0], **TOL[dtype])
    _assert_close(res[0][1], res[1][1], **TOL_BWD[dtype])
    if grad_weights:
        _assert_close(res[0][2], res[1][2], **TOL_DT[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["edge", "mr", "gat", "gcn", "gin", "sage", "rsage"])
def test_small_deepgcn_static_card_matches_cpu(cuda_device, conv):
    """A 3-block res DeepGCNStatic of each zoo conv on the card against the
    CPU: the logits, then each graph layer (head conv and blocks) on the
    same input under a random cotangent: its output, the input's gradient
    (the gathers' backward, K1) and every parameter gradient. The whole
    model's gradients pass kinks (relu, the maxima) in millions of elements,
    where the devices' rounding differences may take another branch; a
    layer's input is the same on both sides, and EdgeConv's near-tied maxima
    (`utils.agreement.edge_max_near_ties`) get no cotangent."""
    from deep_gcns_torch_tpu_torch.models import DeepGCNConfig, DeepGCNStatic
    from deep_gcns_torch_tpu_torch.utils.agreement import layer_results

    gc = _graph(torch.device("cpu"), 16, seed=3, n=1000, e=10000)
    gd = gc.to(cuda_device)
    cfg = DeepGCNConfig(in_channels=16, n_classes=9, n_filters=32, n_blocks=3, conv=conv,
                        heads=4 if conv == "gat" else 1, dropout=0.0)
    models = [DeepGCNStatic(cfg, torch.Generator().manual_seed(0)).to(d).train()
              for d in (cuda_device, torch.device("cpu"))]
    n = gc.n_node
    with torch.no_grad():
        _assert_close(models[0](gd.x, gd)[:n], models[1](gc.x, gc)[:n], 1e-4, 1e-4)
    gen = torch.Generator().manual_seed(4)
    for _, outs in layer_results(models, (gd, gc), conv, "res", gen):
        _assert_close(outs[0][0][:n], outs[1][0][:n], 1e-4, 1e-4)
        _assert_close(outs[0][1], outs[1][1], 1e-3, 1e-4)
        g_max = max(float(v.abs().max()) for v in outs[1][2].values())
        for k, want in outs[1][2].items():
            _assert_close(outs[0][2][k], want, 1e-3, 1e-4, ref_max=g_max)


@pytest.mark.cuda
@pytest.mark.parametrize("with_csc", [True, False])
def test_unaligned_padding_launches_kernels(cuda_device, with_csc):
    """Padding that is no multiple of the JAX package's tiles (N_pad 3001,
    E_pad 30007) turns no route away on the card: GENConv softmax launches
    K2's fused form once a forward with CSC and its message form without,
    a segment sum given ``row_ptr`` launches K1 once, and both match the
    CPU."""
    from deep_gcns_torch_tpu_torch.convs.sparse import GENConv
    from deep_gcns_torch_tpu_torch.ops import segment as tseg

    rng = np.random.default_rng(8)
    n, e = 3000, 30000
    x = rng.standard_normal((n, 32)).astype(np.float32)
    gc = build_graph(x, rng.integers(0, n, e), rng.integers(0, n, e), num_nodes=n,
                     node_pad=3001, edge_pad=30007, with_csc=with_csc)
    assert (gc.num_nodes_padded, gc.num_edges_padded) == (3001, 30007)
    data = torch.from_numpy(rng.standard_normal((gc.num_edges_padded, 32)).astype(np.float32))
    res, counts = [], []
    for g in (gc.to(cuda_device), gc):
        dev = g.senders.device
        conv = GENConv(32, 32, aggr="softmax", learn_t=True,
                       generator=torch.Generator().manual_seed(0)).to(dev)
        xx = g.x.clone().requires_grad_(True)
        before = (tsp.softmax_agg.launches, tsp.softmax_agg_msgs.launches,
                  tsp.csr_seg_sum.launches)
        out = conv(xx, g)
        mid = tsp.csr_seg_sum.launches
        s = tseg.segment_sum(data.to(dev), g.receivers, g.num_nodes_padded, g.edge_mask,
                             row_ptr=g.row_ptr)
        counts.append((tsp.softmax_agg.launches - before[0],
                       tsp.softmax_agg_msgs.launches - before[1],
                       tsp.csr_seg_sum.launches - mid))
        (out ** 2).sum().backward()
        res.append((out.detach(), xx.grad, s))
    assert counts[0] == ((1, 0, 1) if with_csc else (0, 1, 1))
    assert counts[1] == (0, 0, 0)
    _assert_close(res[0][0], res[1][0], 1e-4, 1e-5)
    _assert_close(res[0][1], res[1][1], 1e-3, 1e-4)
    _assert_close(res[0][2], res[1][2], 1e-5, 1e-6)


def _knn_transpose(dev, b, n, k, d, seed):
    """A dilated kNN of uniform random points and its transpose; point 0 of
    cloud 0 is no one's neighbour."""
    from deep_gcns_torch_tpu_torch.ops import gather as tgather
    from deep_gcns_torch_tpu_torch.ops import knn as tknn

    x = torch.rand(b, n, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    idx, _ = tknn.dilated_knn_graph_dense(x, k, d)
    idx[0][idx[0] == 0] = 1
    return idx, tgather.neighbor_transpose(idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 4])
def test_seg_sum_on_knn_transpose(cuda_device, dtype, d):
    """K1's gathered form over a kNN transpose (uneven in-degrees) against
    the plain version; the point with no in-edge exact 0; two launches bit
    for bit."""
    idx, (perm, _, ptr) = _knn_transpose(cuda_device, 4, 2048, 16, d, 7)
    g = torch.randn(idx.numel(), 64, device=cuda_device).to(dtype)
    out = tsp.csr_seg_sum(g, ptr, perm)
    _assert_close(out, tsp.csr_seg_sum_plain(g, ptr, perm), **TOL[dtype])
    assert not out[0].float().abs().any()
    assert torch.equal(tsp.csr_seg_sum(g, ptr, perm), out)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [9, 64])
def test_gather_neighbors_launches(cuda_device, c):
    """At 64 channels the dense gather's backward launches K1 once and its
    forward never; at 9 (the S3DIS head's width) neither does. Both agree
    with the plain index_select and its autograd scatter."""
    from deep_gcns_torch_tpu_torch.ops import gather as tgather

    b, n, k = 4, 1024, 16
    idx, _ = _knn_transpose(cuda_device, b, n, k, 2, 8)
    x = torch.randn(b, n, c, device=cuda_device, requires_grad=True)
    co = torch.randn(b, n, k, c, device=cuda_device)
    tsp.csr_seg_sum.launches = 0
    out = tgather.gather_neighbors(x, idx)
    assert tsp.csr_seg_sum.launches == 0
    (out * co).sum().backward()
    assert tsp.csr_seg_sum.launches == (1 if c >= 32 else 0)
    flat = (idx + (torch.arange(b, device=cuda_device) * n)[:, None, None]).reshape(-1)
    xr = x.detach().clone().requires_grad_(True)
    ref = xr.reshape(b * n, c).index_select(0, flat).reshape(b, n, k, c)
    (ref * co).sum().backward()
    assert torch.equal(out.detach(), ref.detach())
    _assert_close(x.grad, xr.grad, **TOL[torch.float32])
    assert not x.grad[0, 0].abs().any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "cls", "sparse"])
def test_small_point_model_card_matches_cpu(cuda_device, kind):
    """A 3-block point-cloud model on the card against the CPU: the logits
    on the CPU's kNN graphs replayed on the card, then each graph layer on
    the CPU's input and graph (`utils.agreement.point_layer_results`); a
    flip of the card's own kNN must be a near tie (float64 gap within 1e-5
    of the largest distance)."""
    from deep_gcns_torch_tpu_torch.models import (DeepGCNCls, DeepGCNConfig, DenseDeepGCN,
                                                  SparseDeepGCN)
    from deep_gcns_torch_tpu_torch.utils.agreement import KnnReplay, point_layer_results

    gen = torch.Generator().manual_seed(9)
    kw = dict(n_filters=32, n_blocks=3, conv="edge", k=8, dropout=0.0)
    if kind == "dense":
        cls, cfg, x = DenseDeepGCN, DeepGCNConfig(9, 13, **kw), torch.rand(2, 384, 9,
                                                                            generator=gen)
    elif kind == "cls":
        cls, cfg = DeepGCNCls, DeepGCNConfig(3, 40, emb_dims=128, stochastic=False, **kw)
        x = torch.rand(8, 256, 3, generator=gen)
    else:
        cls, cfg = SparseDeepGCN, DeepGCNConfig(9, 13, num_points=384, **kw)
        x = torch.rand(768, 9, generator=gen)
    models = [cls(cfg, torch.Generator().manual_seed(0)).to(d).train()
              for d in (cuda_device, torch.device("cpu"))]
    args = () if kind == "cls" else (None,)
    with torch.no_grad():
        with KnnReplay() as rec:
            want = models[1](x, *args)
        with KnnReplay(rec.graphs) as rep:
            got = models[0](x.to(cuda_device), *args)
    assert all(f["rel_gap"] <= 1e-5 for flips in rep.flips for f in flips)
    _assert_close(got, want, 1e-4, 1e-4)
    for _, outs, flips in point_layer_results(models, x, torch.Generator().manual_seed(4),
                                              sparse=kind == "sparse"):
        assert all(f["rel_gap"] <= 1e-5 for f in flips)
        _assert_close(outs[0][0], outs[1][0], 1e-4, 1e-4)
        _assert_close(outs[0][1], outs[1][1], 1e-3, 1e-4)
        g_max = max(float(v.abs().max()) for v in outs[1][2].values())
        for k, w in outs[1][2].items():
            _assert_close(outs[0][2][k], w, 1e-3, 1e-4, ref_max=g_max)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange,band", [("halo", "off"), ("allgather", "off"),
                                           ("halo", "auto")])
def test_spatial_forward_card_matches_cpu(cuda_device, exchange, band):
    """`SpatialDeeperGCN` (softmax_sg, float32) on two ranks sharing the card
    (gloo, host-staged) against two gloo ranks on the CPU, and each card
    rank's launches: the halo split's four K1 sums a layer, the all-gather's
    K2 message form, or the band route's K3 and K1 on the halo partial (and
    on the leftover where there is one)."""
    import torch_parallel_cases as tpc
    from deep_gcns_torch_tpu_torch.parallel import launch, shard_graph, shard_nodes

    rng = np.random.default_rng(9)
    n, e, layers = 3000, 30000, 3
    s = rng.integers(0, n, e)
    r = np.clip(s + rng.integers(-100, 101, e), 0, n - 1)
    sh = shard_graph(s, r, n, 2, band=band)
    kw = dict(in_channels=32, hidden_channels=32, num_tasks=8, num_layers=layers,
              block="res+", aggr="softmax_sg", t=0.5, norm="layer", mlp_layers=1,
              dropout=0.0)
    model = DeeperGCN(DeeperGCNConfig(**kw), generator=torch.Generator().manual_seed(0))
    case = dict(kind="deeper", cfg=kw, exchange=exchange, shards=sh,
                state={k: v.numpy() for k, v in model.state_dict().items()},
                x=shard_nodes(rng.standard_normal((n, 32)).astype(np.float32), sh))
    outs = [launch(tpc.run_cases, 2, ([case], d), device=d, deadline=300) for d in ("cuda",
                                                                                    "cpu")]
    got, want = (np.concatenate([rk["results"][0]["logits"] for rk in o]) for o in outs)
    _assert_close(torch.from_numpy(got), torch.from_numpy(want), rtol=1e-4, atol_rel=1e-4)
    lo = int(band == "auto" and sh.loc_band[0].fwd.n_lo > 0)
    expect = ({"K1": 4 * layers, "K2": 0, "K2 msgs": 0, "K3": 0} if band == "off"
              and exchange == "halo" else
              {"K1": 0, "K2": 0, "K2 msgs": layers, "K3": 0} if band == "off" else
              {"K1": layers * (lo + 1), "K2": 0, "K2 msgs": 0, "K3": layers})
    for rk in outs[0]:
        assert rk["results"][0]["launches"] == expect


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tp_deeper", "tp_rev", "spatial_tp"])
def test_tensor_parallel_step_card_matches_cpu(cuda_device, kind):
    """One SGD step of `TPDeeperGCN` (batch norm, T=2), `TPRevGCN` (edge
    features, dropout masks drawn on the host, T=2) and `SpatialTPDeeperGCN`
    (layer norm, a 2 × 2 grid) on ranks sharing the card (gloo, host-staged)
    against the same ranks on the CPU, float32: the loss and every entry of
    the gathered single-process `state_dict`."""
    import torch_parallel_cases as tpc
    from deep_gcns_torch_tpu_torch.parallel import launch, shard_graph, shard_nodes

    rng = np.random.default_rng(11)
    n, e = 2000, 20000
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    kw = dict(in_channels=16, hidden_channels=32, num_tasks=8, num_layers=3, block="res+",
              aggr="softmax_sg", t=0.5, norm="batch", mlp_layers=1, dropout=0.0)
    if kind == "tp_rev":
        rkw = dict(hidden_channels=32, num_tasks=8, num_layers=3, group=2, aggr="softmax",
                   dropout=0.2)
        g = build_graph(x[:, :8], s, r, num_nodes=n,
                        edge_attr=rng.standard_normal((e, 8)).astype(np.float32))
        n_pad = g.num_nodes_padded
        model = RevGCN(RevGCNConfig(**rkw), generator=torch.Generator().manual_seed(0))
        keep = rng.random((2, n_pad, 32)) >= 0.2  # the CUDA and CPU generators differ
        case = dict(kind=kind, cfg=rkw, graph=g, lr=0.1,
                    masks=tuple((k / 0.8).astype(np.float32) for k in keep),
                    labels=rng.integers(0, 8, n_pad),
                    species=np.eye(8, dtype=np.float32)[rng.integers(0, 8, n_pad)],
                    nf=rng.standard_normal((n_pad, 8)).astype(np.float32))
        world = 2
    elif kind == "tp_deeper":
        g = build_graph(x, s, r, num_nodes=n)
        model = DeeperGCN(DeeperGCNConfig(**kw), generator=torch.Generator().manual_seed(0))
        case = dict(kind=kind, cfg=kw, graph=g, lr=0.1,
                    labels=rng.integers(0, 8, g.num_nodes_padded))
        world = 2
    else:
        kw["norm"] = "layer"
        sh = shard_graph(s, r, n, 2)
        model = DeeperGCN(DeeperGCNConfig(**kw), generator=torch.Generator().manual_seed(0))
        case = dict(kind=kind, cfg=kw, grid=(2, 2), exchange="halo", shards=sh, lr=0.1,
                    x=shard_nodes(x, sh), mask=sh.node_mask,
                    labels=shard_nodes(rng.integers(0, 8, n)[:, None], sh)[..., 0])
        world = 4
    case["state"] = {k: v.numpy() for k, v in model.state_dict().items()}
    outs = [launch(tpc.run_cases, world, ([case], d), device=d, deadline=300)
            for d in ("cuda", "cpu")]
    got, want = (o[0]["results"][0] for o in outs)
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * max(1.0, abs(want["loss"]))
    ref_max = max(float(np.abs(v).max()) for v in want["state"].values() if np.size(v))
    for k, w in want["state"].items():
        _assert_close(torch.from_numpy(np.asarray(got["state"][k])),
                      torch.from_numpy(np.asarray(w)), 1e-4, 1e-4, ref_max=ref_max)


# K11: RevGAT's fused norm → ReLU → dropout multiply, at the cell's shapes
# (N_pad = 169,472 rows, 169,343 valid). Tolerances, float32: the kernel's
# Welford/Chan statistics and the plain version's two-pass column sums round
# differently, so μ agrees to 1e-5 of the column's spread and rstd, y to 1e-5
# relative above a floor of 1e-5 of max |y|. dw and db are float32 sums over
# 169k rows in different orders, so each column agrees to 1e-5 of the sum of
# its terms' magnitudes, and dx to 1e-5 relative above 1e-5 of max |dx|. A
# ReLU gate flips where z lies within the statistics' rounding of 0 (tens of
# elements in 65 M), and then dx differs there by rstd·w·g: the kernel
# backward is held against the plain backward given the kernel's own μ, rstd
# and cnt (both round z alike, no fma contraction), and the Function's test
# keeps every |z| above 0.4.
K11_N, K11_VALID = 169_472, 169_343


def _k11_inputs(dev, layout, mult_form, seed=0, gates_clear=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = 384 if layout == "c384_strided" else 768
    wide = torch.randn(K11_N, 768, device=dev, generator=gen) * 3.0 + 20.0
    x = torch.chunk(wide, 2, dim=-1)[1] if layout == "c384_strided" else wide
    mask = torch.arange(K11_N, device=dev) < K11_VALID
    w = torch.rand(c, device=dev, generator=gen) + 0.5
    b = torch.randn(c, device=dev, generator=gen) * 0.5
    if gates_clear:  # |x̂| < 6 for 169k normal rows, so |z| > 0.4
        w, b = torch.full_like(w, 0.1), torch.where(b > 0, 1.0, -1.0)
    keep_wide = torch.rand(K11_N, 768, device=dev, generator=gen) >= 0.75
    mult = keep = None
    if mult_form == "float":
        m = keep_wide.float() / 0.25
        mult = torch.chunk(m, 2, dim=-1)[1] if c == 384 else m
    elif mult_form == "keep":
        keep = torch.chunk(keep_wide, 2, dim=-1)[1] if c == 384 else keep_wide
    dy = torch.randn(K11_N, c, device=dev, generator=gen)
    return x, mask, w, b, mult, keep, dy


def _k11_sums_close(got, want, mag):
    """Column sums: |got − want| ≤ 1e-5 · Σ|terms| per column."""
    np.testing.assert_array_less(np.abs((got - want).cpu().numpy()),
                                 1e-5 * mag.cpu().numpy() + 1e-30)


def _k11_grad_terms(x, mask, w, b, mult, keep, dy, mu, rstd):
    """Σ|g| and Σ|g·x̂| per column: the magnitudes behind db and dw."""
    from deep_gcns_torch_tpu_torch.ops import norm_act as tna

    xh = (x - mu) * rstd
    g = tna._apply_mult(dy, mult, keep, 0.25)
    g = torch.where(xh * w + b > 0, g, torch.zeros((), device=x.device))
    return g.abs().sum(0), (g * xh).abs().sum(0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["c384_strided", "c768"])
@pytest.mark.parametrize("mult_form", ["float", "keep", "none"])
def test_k11_batch_norm_act_matches_plain(cuda_device, layout, mult_form):
    """K11 forward and backward against the plain halves: y, μ, rstd, cnt,
    dx, dw, db; two launches bit for bit; the launch counters."""
    from deep_gcns_torch_tpu_torch.ops import norm_act as tna

    x, mask, w, b, mult, keep, dy = _k11_inputs(cuda_device, layout, mult_form)
    assert (layout == "c768") == x.is_contiguous()
    f0, b0 = tna.batch_norm_act_fwd.launches, tna.batch_norm_act_bwd.launches
    y, mu, rstd, cnt = tna.batch_norm_act_fwd(x, mask, w, b, mult, keep, 0.25)
    y_p, mu_p, rstd_p, cnt_p = tna.batch_norm_act_fwd_plain(x, mask, w, b, mult, keep, 0.25)
    assert float(cnt) == float(cnt_p) == K11_VALID
    np.testing.assert_array_less(np.abs((mu - mu_p).cpu().numpy()),
                                 1e-5 / rstd_p.cpu().numpy())
    _assert_close(rstd, rstd_p, 1e-5, 0.0)
    _assert_close(y, y_p, 1e-5, 1e-5)
    dx, dw, db = tna.batch_norm_act_bwd(dy, x, mask, w, b, mult, keep, 0.25, mu, rstd, cnt)
    dx_p, dw_p, db_p = tna.batch_norm_act_bwd_plain(dy, x, mask, w, b, mult, keep, 0.25, mu,
                                                    rstd, cnt)
    mag_b, mag_w = _k11_grad_terms(x, mask, w, b, mult, keep, dy, mu, rstd)
    _k11_sums_close(db, db_p, mag_b)
    _k11_sums_close(dw, dw_p, mag_w)
    _assert_close(dx, dx_p, 1e-5, 1e-5)
    y2, mu2, rstd2, _ = tna.batch_norm_act_fwd(x, mask, w, b, mult, keep, 0.25)
    dx2, dw2, db2 = tna.batch_norm_act_bwd(dy, x, mask, w, b, mult, keep, 0.25, mu, rstd, cnt)
    for a, a2 in ((y, y2), (mu, mu2), (rstd, rstd2), (dx, dx2), (dw, dw2), (db, db2)):
        assert torch.equal(a, a2), "two launches must give the same bits"
    torch.cuda.synchronize()
    assert (tna.batch_norm_act_fwd.launches - f0, tna.batch_norm_act_bwd.launches - b0) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,mult_form", [("c384_strided", "float"), ("c768", "keep")])
def test_k11_function_matches_plain_function(cuda_device, layout, mult_form):
    """The Function on the kernels against the same Function on the plain
    halves, through autograd: a block's strided shapes with the shared mask,
    the head's with its keep mask."""
    from deep_gcns_torch_tpu_torch.ops import norm_act as tna

    x, mask, w, b, mult, keep, dy = _k11_inputs(cuda_device, layout, mult_form, seed=1,
                                                gates_clear=True)
    res = []
    for fn in (tna.batch_norm_act, tna.batch_norm_act_plain):
        xx = x.detach().requires_grad_(True)
        ww, bb = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = fn(xx, mask, ww, bb, mult=mult, keep=keep, rate=0.75)
        y.backward(dy)
        res.append((y.detach(), xx.grad, ww.grad, bb.grad))
    _assert_close(res[0][0], res[1][0], 1e-5, 1e-5)
    _assert_close(res[0][1], res[1][1], 1e-5, 1e-5)
    _, mu, rstd, _ = tna.batch_norm_act_fwd_plain(x, mask, w, b)
    mag_b, mag_w = _k11_grad_terms(x, mask, w, b, mult, keep, dy, mu, rstd)
    _k11_sums_close(res[0][2], res[1][2], mag_w)
    _k11_sums_close(res[0][3], res[1][3], mag_b)


# K11's DeeperGCN forms at ResGEN's shape ([169,472 × 128], 169,343 valid)
# and at an odd C (scalar loads): the training form with the running update
# and a keep mask, and the evaluation form, against a float64 two-pass plain
# twin (not the eager one-pass chain, whose variance cancels on the large
# column means). Tolerances as K11's above: float32 statistics to 1e-5 of
# the column's spread, y and the running statistics to 1e-5 relative above
# a floor of 1e-5 of their largest value; dx, dw, db against the float64
# backward given the kernel's own statistics, with every |z| above 0.4.
def _k11_deeper_inputs(dev, c, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(K11_N, c, device=dev, generator=gen) * 3.0 + 20.0
    mask = torch.arange(K11_N, device=dev) < K11_VALID
    b = torch.where(torch.rand(c, device=dev, generator=gen) > 0.5, 1.0, -1.0)
    w = torch.full((c,), 0.1, device=dev)  # |x̂| < 6 for 169k normal rows, so |z| > 0.4
    keep = torch.rand(K11_N, c, device=dev, generator=gen) >= 0.5
    rm = torch.randn(c, device=dev, generator=gen) * 5.0 + 20.0
    rv = torch.rand(c, device=dev, generator=gen) * 4.0 + 8.0
    dy = torch.randn(K11_N, c, device=dev, generator=gen)
    return x, mask, w, b, keep, rm, rv, dy


def _f64(*ts):
    return [None if t is None else t.double() if t.is_floating_point() else t for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 37])
def test_k11_training_form_with_running_statistics(cuda_device, c):
    """The forward with the keep mask and the running update, and its
    backward, against the float64 twin; two calls give the same bits; one
    launch each way."""
    from deep_gcns_torch_tpu_torch.ops import norm_act as tna

    x, mask, w, b, keep, rm0, rv0, dy = _k11_deeper_inputs(cuda_device, c)
    f0, b0 = tna.batch_norm_act_fwd.launches, tna.batch_norm_act_bwd.launches
    outs = []
    for _ in range(2):
        rm, rv = rm0.clone(), rv0.clone()
        y, mu, rstd, cnt = tna.batch_norm_act_fwd(x, mask, w, b, None, keep, 0.5,
                                                  running=(rm, rv, 0.1))
        dx, dw, db = tna.batch_norm_act_bwd(dy, x, mask, w, b, None, keep, 0.5, mu, rstd, cnt)
        outs.append((y, mu, rstd, rm, rv, dx, dw, db))
    for a, a2 in zip(*outs):
        assert torch.equal(a, a2), "two calls must give the same bits"
    torch.cuda.synchronize()
    assert (tna.batch_norm_act_fwd.launches - f0, tna.batch_norm_act_bwd.launches - b0) == (2, 2)
    y, mu, rstd, rm, rv, dx, dw, db = outs[0]
    x6, w6, b6, rm6, rv6 = _f64(x, w, b, rm0, rv0)
    y6, mu6, rstd6, cnt6 = tna.batch_norm_act_fwd_plain(x6, mask, w6, b6, None, keep, 0.5,
                                                        running=(rm6, rv6, 0.1))
    assert float(cnt) == float(cnt6) == K11_VALID
    np.testing.assert_array_less(np.abs((mu.double() - mu6).cpu().numpy()),
                                 1e-5 / rstd6.cpu().numpy())
    _assert_close(rstd, rstd6, 1e-5, 0.0)
    _assert_close(y, y6, 1e-5, 1e-5)
    _assert_close(rm, rm6, 1e-5, 1e-5)
    _assert_close(rv, rv6, 1e-5, 1e-5)
    dx6, dw6, db6 = tna.batch_norm_act_bwd_plain(*_f64(dy, x), mask, w6, b6, None, keep, 0.5,
                                                 *_f64(mu, rstd, cnt))
    mag_b, mag_w = _k11_grad_terms(x, mask, w, b, None, keep, dy, mu, rstd)
    _k11_sums_close(db.double(), db6, mag_b)
    _k11_sums_close(dw.double(), dw6, mag_w)
    _assert_close(dx, dx6, 1e-5, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 37])
def test_k11_evaluation_form(cuda_device, c):
    """y = relu((x − running_mean)·rsqrt(running_var + eps)·w + b) in one
    launch against the float64 twin, the same bits twice; through autograd
    dx, dw and db against the float64 Function on the plain halves."""
    from deep_gcns_torch_tpu_torch.ops import norm_act as tna

    x, mask, w, b, _, rm, rv, dy = _k11_deeper_inputs(cuda_device, c, seed=1)
    f0 = tna.batch_norm_act_fwd.launches
    y, rstd = tna.batch_norm_act_eval_fwd(x, rm, rv, w, b)
    y2, rstd2 = tna.batch_norm_act_eval_fwd(x, rm, rv, w, b)
    torch.cuda.synchronize()
    assert tna.batch_norm_act_fwd.launches - f0 == 2
    assert torch.equal(y, y2) and torch.equal(rstd, rstd2)
    y6, rstd6 = tna.batch_norm_act_eval_fwd_plain(*_f64(x, rm, rv, w, b))
    _assert_close(rstd, rstd6, 1e-6, 0.0)
    _assert_close(y, y6, 1e-5, 1e-5)
    res = []
    for fn, args in ((tna.batch_norm_act_eval, (x, rm, rv, w, b)),
                     (tna.batch_norm_act_eval_plain, _f64(x, rm, rv, w, b))):
        xx, ww, bb = (a.detach().clone().requires_grad_(True) for a in (args[0], *args[3:]))
        fn(xx, args[1], args[2], ww, bb).backward(dy.to(xx.dtype))
        res.append((xx.grad, ww.grad, bb.grad))
    _assert_close(res[0][0], res[1][0], 1e-5, 1e-5)
    g = torch.where((x - rm) * rstd * w + b > 0, dy, torch.zeros((), device=x.device))
    _k11_sums_close(res[0][2].double(), res[1][2], g.abs().sum(0))
    _k11_sums_close(res[0][1].double(), res[1][1], (g * (x - rm) * rstd).abs().sum(0))


@pytest.mark.cuda
@pytest.mark.parametrize("carry", ["float32", "bfloat16"])
def test_deeper_gcn_norms_take_k11(cuda_device, carry):
    """A res+ DeeperGCN with batch norm on the card: with a float32
    residual stream each prologue and the final norm is one K11 launch
    forward (training and evaluation) and one backward, no route miss, and
    the running statistics move once; a bfloat16 carry (with bfloat16
    compute, which it needs) takes the eager chain and counts a miss a
    norm."""
    from deep_gcns_torch_tpu_torch.ops import norm_act as tna
    from deep_gcns_torch_tpu_torch.ops.route_misses import fastpath_misses

    rng = np.random.default_rng(3)
    n, layers = 2000, 4
    g = build_graph(rng.standard_normal((n, 32)).astype(np.float32),
                    rng.integers(0, n, 20000), rng.integers(0, n, 20000),
                    num_nodes=n).to(cuda_device)
    cfg = DeeperGCNConfig(in_channels=32, hidden_channels=64, num_tasks=7, num_layers=layers,
                          block="res+", aggr="softmax", t=0.5, norm="batch", dropout=0.5,
                          residual_dtype=carry, compute_dtype=carry)
    model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    def misses():
        return sum(v for k, v in fastpath_misses().items() if k.startswith("deeper.norm_act:"))

    f0, b0 = tna.batch_norm_act_fwd.launches, tna.batch_norm_act_bwd.launches
    m0, c0 = misses(), fastpath_misses().get("deeper.norm_act:bfloat16 carry", 0)
    model.train()
    model(g.x, g, gen).float().sum().backward()
    model.eval()
    with torch.no_grad():
        model(g.x, g)
    torch.cuda.synchronize()
    launches = (tna.batch_norm_act_fwd.launches - f0, tna.batch_norm_act_bwd.launches - b0)
    missed = misses() - m0
    if carry == "float32":
        assert launches == (2 * layers, layers) and missed == 0
    else:
        assert launches == (0, 0) and missed == 2 * layers
        assert fastpath_misses()["deeper.norm_act:bfloat16 carry"] - c0 == missed
    for norm in model.norms:
        assert int(norm.num_batches_tracked) == 1
        assert not torch.equal(norm.running_var, torch.ones_like(norm.running_var))
