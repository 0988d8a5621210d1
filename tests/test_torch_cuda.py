"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs on a machine that has only PyTorch:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets up JAX for the other
test files.)

Tolerances (those of chip_smoke.py): each per-edge term of K1, K2 and K3 is
bit for bit the plain version's; only the order of the float32 sums differs,
so float32 agrees to 1e-5 relative and bfloat16 to one ulp (2^-7 relative) of
the final rounding, each above a floor of 1e-5 of the largest value, where
sums of mixed signs cancel.
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
# the backward rounds den, q and K1's output to x's dtype once each
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
    cmax = tsp.fused_cmax(x, t, 1e-7)
    k1, k2 = tsp.csr_seg_sum.launches, tsp.softmax_agg.launches

    out, den = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7)
    out_p, den_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax, 1e-7)
    _assert_close(out, out_p, **tol)
    _assert_close(den, den_p, **tol)
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
        o = fn(xx, g.senders, g.row_ptr, g.csc_receivers, g.csc_col_ptr, tt, eps=1e-7,
               grad_weights=grad_weights)
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
    cmax = tsp.fused_cmax(x, t, 1e-7, ee)
    k2, k4 = tsp.softmax_agg.launches_ee, tsp.softmax_bwd_csc.launches
    out, den = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
    out_p, den_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
    _assert_close(out, out_p, **tol)
    _assert_close(den, den_p, **tol)
    q = torch.randn(g.num_nodes_padded, c, device=cuda_device).to(dtype)
    for gw in (False, True):
        qo = torch.cat([q, out_p], 1).contiguous() if gw else q
        args = (x, ee_csc, qo, g.csc_col_ptr, g.csc_receivers, t, cmax, 1e-7, gw)
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
        o = fn(xx, g.senders, g.row_ptr, g.csc_receivers, g.csc_col_ptr, tt, ee=ee,
               ee_csc=ec, eps=1e-7, grad_weights=grad_weights)
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
        tsp.softmax_agg(x, g.senders, g.row_ptr.cpu(), torch.tensor([1.0], device=x.device),
                        tsp.fused_cmax(x, torch.tensor([1.0], device=x.device), 1e-7), 1e-7)


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
    edge (out and den exact 0), and two launches bit for bit the same."""
    g = _k2_corner_graph(cuda_device)
    x, ee, _ = _edge_inputs(g, c, dtype, seed=4)
    ee = ee if with_ee else None
    t = torch.tensor([0.7], device=cuda_device)
    cmax = tsp.fused_cmax(x, t, 1e-7, ee)
    before = (tsp.softmax_agg.launches, tsp.softmax_agg.launches_ee)
    out, den = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
    out_p, den_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
    _assert_close(out, out_p, **TOL[dtype])
    _assert_close(den, den_p, **TOL[dtype])
    empty = (g.row_ptr[1:] == g.row_ptr[:-1]).nonzero()[:, 0]
    assert empty.numel() >= 100
    assert not out[empty].any() and not den[empty].any()
    out2, den2 = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
    assert torch.equal(out, out2) and torch.equal(den, den2)
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
    cmax = tsp.fused_cmax(x, t, 1e-7, ee)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q = torch.randn(g.num_nodes_padded, c, device=cuda_device, generator=gen).to(dtype)
    if grad_weights:
        out = torch.randn(g.num_nodes_padded, c, device=cuda_device, generator=gen).to(dtype)
        q = torch.cat([q, out], 1).contiguous()
    args = (x, ee_csc, q, g.csc_col_ptr, g.csc_receivers, t, cmax, 1e-7, grad_weights)
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
    embeddings."""
    g, x, ee, ee_csc = _ogb_inputs(cuda_device, shape)
    tol = TOL[torch.float32]
    t = torch.tensor([1.0], device=cuda_device)
    cmax = tsp.fused_cmax(x, t, 1e-7, ee)
    out, den = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
    out_p, den_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
    _assert_close(out, out_p, **tol)
    _assert_close(den, den_p, **tol)
    q = torch.randn(g.num_nodes_padded, x.shape[1], device=cuda_device)
    if ee is None:
        args = (q, g.csc_col_ptr, g.csc_receivers)
        _assert_close(tsp.csr_seg_sum(*args), tsp.csr_seg_sum_plain(*args), **tol)
        return
    for gw in (False, True):
        qo = torch.cat([q, out_p], 1).contiguous() if gw else q
        args = (x, ee_csc, qo, g.csc_col_ptr, g.csc_receivers, t, cmax, 1e-7, gw)
        dx, dee, dt = tsp.softmax_bwd_csc(*args)
        dx_p, dee_p, dt_p = tsp.softmax_bwd_csc_plain(*args)
        _assert_close(dx, dx_p, **tol)
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
