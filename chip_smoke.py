#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (a phase that finds any disagreement raises at its end, after printing
every check; nothing is caught):

1. device: versions, the card's name and power limit, and the build of every
   kernel from `deep_gcns_torch_tpu_torch/csrc` (one `nvcc` per source, in
   parallel, into the git-ignored build directory);
2. kernels: K1 (plain and gathered form) and K2 in float32 and bfloat16, and
   the fused aggregation's autograd backward, against the plain versions at
   the main path's shapes (ogbn-arxiv size: N=169,343, 14 random in-edges per
   node plus self-loops, C=128);
3. agreement: a small DeeperGCN on the card (kernels) against the same
   weights on the CPU (plain versions): logits and gradients;
4. main path, gather route: ResGEN-28 (res+, softmax_sg t=0.1, batch norm,
   one-layer MLP, dropout 0.5, bf16 compute, C=128, 40 classes, Adam 1e-2)
   trained through the app's `train_step` for one warm-up and 5 timed steps,
   then one `predict`; the launch counts must show 28 K2 launches per
   forward and 28 K1 launches per backward;
5. profile: a `torch.profiler` trace of two more train steps, printed as
   device time by kernel and the device's busy share of the window;
6. timing: CUDA-event times of K1 (gathered form, as the backward calls it)
   and K2 at the main shapes, beside their plain versions, a library yardstick
   for K1 and the least time the card could take for the same work;
7. band graph: the realistic power-law community graph (N=169,343, average
   degree 15, `cluster_order` with clusters of 16,384, `attach_band` with
   window and hubs "auto"), built on the host by the native library (which
   must load), with its window, coverage, hub counts and device bytes;
8. band kernels: K3 against its plain version in float32 and bfloat16 on the
   packed [N_pad, 256] forward table and on an [N_pad, 128] table, with a
   hash edge-drop (p=0.3) in both id orders, and `band_spmm` and
   `band_softmax_agg` (softmax_sg and learn_t) forward and backward against
   the same Functions on the plain versions;
9. main path, band route: ResGEN-28 on the band graph, one warm-up, 5 timed
   steps and a `predict`; K3 must launch 56 times a step and 28 times a
   `predict`, K1 as often wherever the leftover is not empty, K2 never;
10. profile of two band-route steps;
11. the same graph on the gather route (`g.replace(band=None)`): one warm-up
   and 3 steps, and the card's band/gather step ratio;
12. timing of K3 in bf16 on the packed forward table, its bound and a
   `torch.sparse.mm` yardstick of the in-band adjacency;
13. cluster graph: one ogbn-proteins cluster under the reference's 10-way
   random partition, at `bench.py:221-231`'s shape (N=13,000, E=780,000
   uniform random edges, seed 0), with 8-dim edge features in both edge
   orders, a species one-hot, 8 node features and 112 binary tasks;
14. edge kernels: K2 with edge embeddings and K4 (with and without dt) in
   float32 and bfloat16 at C=40 (a RevGCN group) and C=64 (DyResGEN), and
   the fused Function with edge embeddings forward and backward
   (softmax_sg and learn_t), against the plain versions;
15. edge agreement: a small RevGCN and a small DyResGEN on the card against
   the same weights on the CPU: logits and every gradient;
16. main path, RevGCN at L=101 then L=1001 (80 channels, group 2, bf16)
   through `apps/ogbn_proteins_rev`'s `train_step` and `predict`: one
   warm-up, 2 timed steps and a `predict` each; K2 with `ee` must launch
   2·L·G times a step and L·G times a `predict`, K4 L·G times a step, K1,
   K3 and K2 without `ee` never; a profile of one L=101 step; the O(1)
   memory check: the peak may grow from L=101 to L=1001 by no more than the
   parameters, gradients and Adam moments of the extra layers (16 bytes a
   parameter) plus 256 MB;
17. main path, DyResGEN-112 (C=64, learned t, per-layer edge encoders,
   bf16) through `apps/ogbn_proteins`: one warm-up, 3 timed steps and a
   `predict`; K2 with `ee` 112 launches a step and a `predict`, K4 112 a
   step;
18. app: `apps/ogbn_proteins_rev.main` for one epoch on synthetic
   ogbn-proteins (132,534 nodes, degree 60, 10 clusters, 28 layers, 5
   evaluation parts, bf16), with its host partition seconds;
19. timing of K2 with `ee` and K4 in bf16 at C=40 on the cluster graph,
   beside their plain versions and bounds.

The line before the last is a JSON object listing the kernels; the last line
is `{"ok": true, "device": {...}}`. `--rehearse-cpu` runs every phase on the
CPU at a tiny size through the plain versions, for checking the script
without a card; it prints no device result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "deep_gcns_torch_tpu_torch"

# published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# tolerances, kernel against plain version: |a - b| <= rtol*|b| + atol_rel*max|b|.
# Each per-edge term is bit for bit the same in kernel and plain version; only
# the order of the float32 sums differs, and in bf16 the final rounding of a
# sum may then land one ulp (2^-7 relative at most) away.
TOL_F32 = dict(rtol=1e-5, atol_rel=1e-5)          # summation order only
TOL_BF16 = dict(rtol=2.0 ** -7, atol_rel=1e-5)    # one bf16 ulp + summation order
# backward in bf16: den, q and K1's output each round to bf16 once, so an ulp
# of difference can pass through up to three roundings
TOL_BWD_BF16 = dict(rtol=2.0 ** -5, atol_rel=1e-4)
# dt is a float32 sum over N*C terms with cancellation (a derivative of a
# sum of squares); in bf16 its terms carry the K1 output's ulps
TOL_DT = {"f32": dict(rtol=1e-4, atol_rel=0.0), "bf16": dict(rtol=1e-2, atol_rel=0.0)}
# the band route in bf16: A @ x is K3's sum plus the hub products plus K1's
# leftover sum, each rounded to bf16 before the next `+`, and the softmax
# quotient divides two such sums, so one ulp of a partial sum can move the
# result by a few ulps of its own
TOL_BAND_BF16 = dict(rtol=2.0 ** -5, atol_rel=1e-4)
BF16_TENSOR_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak, for information
# the library yardstick (torch's bf16 sparse product) rounds its partial sums
# to bf16: its error reaches an ulp of the largest partial sum, which this
# floor covers while a different function would still miss by O(max|ref|)
TOL_LIBRARY = dict(rtol=2.0 ** -5, atol_rel=2.0 ** -5)
# the fused Function with edge embeddings and learned weights in bf16: one
# ulp of `out` moves the factor 1 + t·(m − out) of a single edge's term by
# t·2^-8·|out|, which may cancel to near 0, so the floor is one bf16 ulp of
# the largest value
TOL_EE_LEARN_T_BF16 = dict(rtol=2.0 ** -5, atol_rel=2.0 ** -7)
# the O(1)-memory check's allowance beside the optimizer state
MEMORY_SLACK_BYTES = 256 * 2 ** 20


def log(*a):
    print(*a, flush=True)


class Checks:
    """Prints every comparison; `raise_if_failed` ends a phase that had a miss."""

    def __init__(self, phase):
        self.phase, self.failed = phase, []

    def close(self, name, got, want, rtol, atol_rel, ref_max=None):
        """``ref_max`` (default max|want|) scales the absolute floor."""
        got, want = got.detach().float(), want.detach().float()
        err = (got - want).abs()
        if ref_max is None:
            ref_max = float(want.abs().max()) if want.numel() else 0.0
        limit = rtol * want.abs() + atol_rel * ref_max
        max_err = float(err.max()) if err.numel() else 0.0
        ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
              and bool((err <= limit).all()))
        log(f"[check] {name}: max_abs_err={max_err:.3e} (rtol={rtol:.3e}, "
            f"atol={atol_rel:.0e}*max|ref|={atol_rel * ref_max:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)
        return max_err

    def raise_if_failed(self):
        if self.failed:
            raise AssertionError(f"{self.phase}: {len(self.failed)} checks failed: "
                                 f"{self.failed}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_device(dev):
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if dev.type != "cuda":
        return {}
    # float32 products in full float32, as the plain versions and the JAX
    # package compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    log(f"[device] nvcc: {ver.stdout.strip().splitlines()[-1]}")
    name_limit = smi("name,power.limit")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {name_limit}")
    t0 = time.time()
    paths = _build.build(verbose=True)
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f}s: "
        f"{sorted(os.path.basename(p) for p in paths.values())}")
    return {"smi": name_limit}


def main_graph(n, dev):
    t0 = time.time()
    g, labels = random_node_graph(np.random.default_rng(0), n, 14, 128, num_classes=40,
                                  self_loops=True)
    log(f"[graph] N={g.n_node} E={g.n_edge} N_pad={g.num_nodes_padded} "
        f"E_pad={g.num_edges_padded} built in {time.time() - t0:.1f}s")
    return g.to(dev), labels


def phase_kernels(g):
    """K1 (both forms) and K2 in f32 and bf16, and the autograd backward,
    against the plain versions on the same inputs."""
    dev = g.senders.device
    chk = Checks("kernels")
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    t = torch.tensor([0.1], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        tag = "f32" if dtype == torch.float32 else "bf16"
        x = g.x.to(dtype).contiguous()
        cmax = tsp.fused_cmax(x, t, 1e-7)
        out, den = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7)
        out_p, den_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax, 1e-7)
        e2 = max(chk.close(f"K2 out {tag}", out, out_p, **tol),
                 chk.close(f"K2 den {tag}", den, den_p, **tol))
        msgs = torch.randn(g.num_edges_padded, 128, device=dev, generator=gen).to(dtype)
        e1a = chk.close(f"K1 plain form {tag}", tsp.csr_seg_sum(msgs, g.row_ptr),
                        tsp.csr_seg_sum_plain(msgs, g.row_ptr), **tol)
        src = torch.randn(g.num_nodes_padded, 128, device=dev, generator=gen).to(dtype)
        e1b = chk.close(f"K1 gathered form {tag}",
                        tsp.csr_seg_sum(src, g.csc_col_ptr, g.csc_receivers),
                        tsp.csr_seg_sum_plain(src, g.csc_col_ptr, g.csc_receivers), **tol)
        del msgs, src, out, den, out_p, den_p
        tol_b = TOL_F32 if dtype == torch.float32 else TOL_BWD_BF16
        for gw in (False, True):
            res = []
            for fn in (tsp.fused_softmax_gather_agg, tsp.fused_softmax_gather_agg_plain):
                xx = x.detach().clone().requires_grad_(True)
                tt = t.clone().requires_grad_(gw)
                o = fn(xx, g.senders, g.row_ptr, g.csc_receivers, g.csc_col_ptr, tt,
                       eps=1e-7, grad_weights=gw)
                (o.float() ** 2).sum().backward()
                res.append((o.detach(), xx.grad, tt.grad))
            name = f"backward {'learn_t' if gw else 'softmax_sg'} {tag}"
            chk.close(f"{name} out", res[0][0], res[1][0], **tol)
            e1b = max(e1b, chk.close(f"{name} dx", res[0][1], res[1][1], **tol_b))
            if gw:
                chk.close(f"{name} dt", res[0][2], res[1][2], **TOL_DT[tag])
            del res
        errs[tag] = {"K1": max(e1a, e1b), "K2": e2}
    sync(dev)
    chk.raise_if_failed()
    return errs


def phase_agreement(dev):
    """A small DeeperGCN on ``dev`` against the same weights on the CPU."""
    chk = Checks("agreement")
    gc, _ = random_node_graph(np.random.default_rng(2), 3000, 10, 32, num_classes=7,
                              self_loops=True)
    cfg = DeeperGCNConfig(in_channels=32, hidden_channels=64, num_tasks=7, num_layers=4,
                          block="res+", aggr="softmax", learn_t=True, t=0.5, norm="batch",
                          mlp_layers=1, dropout=0.0)
    co = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (gc.num_nodes_padded, 7)).astype(np.float32))
    outs = []
    for d in (dev, torch.device("cpu")):
        model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)).to(d)
        model.train()
        gd = gc.to(d)
        logits = model(gd.x, gd)
        (logits * co.to(d)).sum().backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    # float32 through 4 layers: summation order in K1/K2, BatchNorm and
    # matmuls. The absolute floor of the gradients is set by the largest
    # gradient of all: a bias that feeds a BatchNorm has a true gradient of 0,
    # and what both devices return for it is rounding noise.
    chk.close("small DeeperGCN logits, card vs cpu", outs[0][0], outs[1][0], 1e-4, 1e-4)
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k in outs[1][1]:
        chk.close(f"small DeeperGCN grad {k}", outs[0][1][k], outs[1][1][k], 1e-3, 1e-4,
                  ref_max=g_max)
    chk.raise_if_failed()


def main_model(dev, layers):
    cfg = DeeperGCNConfig(in_channels=128, hidden_channels=128, num_tasks=40,
                          num_layers=layers, block="res+", aggr="softmax_sg", t=0.1,
                          norm="batch", mlp_layers=1, dropout=0.5,
                          compute_dtype="bfloat16")
    model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    return model, make_optimizer("adam", model.parameters(), 1e-2)


def reset_launches():
    tsp.csr_seg_sum.launches = 0
    tsp.softmax_agg.launches = 0
    tsp.softmax_agg.launches_ee = 0
    tband.band_call.launches = 0
    tsp.softmax_bwd_csc.launches = 0


def read_launches():
    return {"K1": tsp.csr_seg_sum.launches, "K2": tsp.softmax_agg.launches,
            "K2 ee": tsp.softmax_agg.launches_ee, "K3": tband.band_call.launches,
            "K4": tsp.softmax_bwd_csc.launches}


def no_launches():
    return {"K1": 0, "K2": 0, "K2 ee": 0, "K3": 0, "K4": 0}


def expected_launches(g, layers, steps):
    """Kernel launches of (steps + 1) train steps and one `predict`: every
    forward runs one aggregation per layer, every backward one more. The
    gather route runs K2 forward and K1 backward; the band route K3 both ways,
    plus K1 wherever that direction's leftover is not empty."""
    want = no_launches()
    if g.senders.device.type != "cuda":
        return want  # CPU tensors never launch a kernel
    fwd, bwd = layers * (steps + 2), layers * (steps + 1)
    if g.band is None:
        want.update(K1=bwd, K2=fwd)
        return want
    lo_f, lo_b = int(g.band.fwd.n_lo > 0), int(g.band.bwd.n_lo > 0)
    want.update(K1=fwd * lo_f + bwd * lo_b, K3=fwd + bwd)
    return want


def phase_main_path(g, labels, layers, steps, tag="main"):
    """ResGEN-28 through the app's `train_step` and `predict` on ``g``; the
    launch counts are set to 0 just before and read just after."""
    dev = g.senders.device
    n = g.n_node
    lab = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    lab[:n] = torch.from_numpy(np.asarray(labels))
    lab = lab.to(dev)
    model, opt = main_model(dev, layers)
    gen = torch.Generator(device=dev).manual_seed(1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    reset_launches()
    loss = ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen)  # warm-up
    sync(dev)
    losses, times = [float(loss)], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    pred = ogbn_arxiv.predict(model, g)
    sync(dev)
    predict_s = time.perf_counter() - t0
    launches = read_launches()

    log(f"[{tag}] losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: loss is not finite")
    if pred.shape != (g.num_nodes_padded,) or int(pred.min()) < 0 or int(pred.max()) >= 40:
        raise AssertionError(f"{tag}: predict gave shape {tuple(pred.shape)} range "
                             f"[{int(pred.min())}, {int(pred.max())}]")
    want = expected_launches(g, layers, steps)
    log(f"[{tag}] launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != expected {want}")
    step = sorted(times)[len(times) // 2]
    info = {"step_ms_median": step * 1e3, "step_ms_min": min(times) * 1e3,
            "step_ms_all": [v * 1e3 for v in times], "predict_ms": predict_s * 1e3,
            "edge_messages_per_s": g.n_edge * layers / step, "launches": launches}
    if dev.type == "cuda":
        info["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        info["smi_after_steps"] = smi("clocks.sm,power.draw,temperature.gpu")
    log(f"[{tag}] {json.dumps(info)}")
    return info, (model, opt, lab, gen)


def arxiv_step(g, state):
    model, opt, lab, gen = state
    return lambda: ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen)


def phase_profile(dev, step, steps=2, tag="profile"):
    """Device time by kernel over ``steps`` calls of the train step ``step``,
    and the device's busy share of that window (host clock around the
    steps, ending in a sync)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # device-side events only: the kernels and memory copies
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] {steps} train steps: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of the window), "
        f"{sum(r[1] for r in rows) // steps} device calls per step")
    for dev_us, count, key in rows[:25]:
        log(f"[{tag}] {dev_us / 1e3 / steps:10.3f} ms/step {count // steps:6d} calls/step "
            f"{100 * dev_us / max(busy, 1e-9):5.1f}%  {key[:160]}")


def time_fn(fn, dev, iters):
    """Mean time of one call: CUDA events around `iters` calls on the card,
    the host clock on the CPU; after warm-up calls."""
    for _ in range(2):
        fn()
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(bytes_moved, flops):
    b_ms, f_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def phase_timing(g, errs, launches, iters):
    """K1 (gathered form) and K2 in bf16 at the main path's shapes."""
    dev = g.senders.device
    chk = Checks("timing")
    n_pad, e, c = g.num_nodes_padded, g.n_edge, 128
    x = g.x.to(torch.bfloat16).contiguous()
    t = torch.tensor([0.1], device=dev)
    cmax = tsp.fused_cmax(x, t, 1e-7)
    q = torch.randn(n_pad, c, device=dev).to(torch.bfloat16)
    k2_ms = time_fn(lambda: tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7), dev,
                    iters)
    k2_plain = time_fn(lambda: tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax,
                                                     1e-7), dev, 3)
    k1_ms = time_fn(lambda: tsp.csr_seg_sum(q, g.csc_col_ptr, g.csc_receivers), dev, iters)
    k1_plain = time_fn(lambda: tsp.csr_seg_sum_plain(q, g.csc_col_ptr, g.csc_receivers),
                       dev, 3)
    # yardstick (never called by the port): the same sum as one sparse product
    # with the CSR matrix Aᵀ[n, r] = #edges n→r (repeated edges summed), built
    # once. The CPU rehearsal runs it in float32: the CPU's sparse product has
    # no bfloat16.
    qy = q if dev.type == "cuda" else q.float()
    coo = torch.sparse_coo_tensor(
        torch.stack([g.csc_senders[:e].long(), g.csc_receivers[:e].long()]),
        torch.ones(e, device=dev), (n_pad, n_pad),
        check_invariants=True).coalesce().to_sparse_csr()
    at = torch.sparse_csr_tensor(coo.crow_indices(), coo.col_indices(),
                                 coo.values().to(qy.dtype), (n_pad, n_pad),
                                 check_invariants=True)
    lib_ms = time_fn(lambda: torch.sparse.mm(at, qy), dev, iters)
    chk.close("library yardstick sparse.mm vs K1", torch.sparse.mm(at, qy),
              tsp.csr_seg_sum(q, g.csc_col_ptr, g.csc_receivers), **TOL_LIBRARY)
    chk.raise_if_failed()

    idx_b = 4 * e + 4 * (n_pad + 1)
    # K1: q read once, out written once (bf16), the CSC index and pointer; one
    # f32 add per (edge, channel)
    k1_bound = bound(2 * n_pad * c * 2 + idx_b, e * c)
    # K2: x read once, out and den written once (bf16), senders, row_ptr, cmax
    # and t; per (edge, channel): max, add, mul, sub, exp, mul, 2 roundings,
    # 2 adds
    k2_bound = bound(n_pad * c * 2 + idx_b + 4 * c + 4 + 2 * n_pad * c * 2, 10 * e * c)
    rows = [
        {"name": "K1 seg_sum_csr", "route": "cuda",
         "source": f"{PKG}/csrc/seg_sum.cu",
         "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:252",
         "launches": launches["K1"], "max_abs_err": errs["bf16"]["K1"], "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": lib_ms},
        {"name": "K2 softmax_agg", "route": "cuda",
         "source": f"{PKG}/csrc/softmax_agg.cu",
         "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:322",
         "launches": launches["K2"], "max_abs_err": errs["bf16"]["K2"], "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
    ]
    log("[timing] K2 has no single PyTorch call that computes it: library_ms is null")
    log(f"[timing] max errors f32 {errs['f32']} bf16 {errs['bf16']}; "
        f"exp count per K2 call {e * c}")
    return rows


def band_graph(n, dev):
    """The realistic graph of the band route, built on the host: power-law
    community edges, cluster order, features, then the band (window and hubs
    "auto")."""
    t0 = time.time()
    lib_ok = native.available()  # builds the host library with g++ on first use
    t_lib = time.time() - t0
    if not lib_ok:
        raise AssertionError("the native host library did not build or load: the band "
                             "builder would run its numpy version")
    rng = np.random.default_rng(0)
    t0 = time.time()
    s, r = powerlaw_community_edges(rng, n, 15)
    t_edges = time.time() - t0
    t0 = time.time()
    perm = cluster_order(s, r, n, cluster_size=16384)
    s, r = permute_graph(perm, s, r)
    t_order = time.time() - t0
    x = rng.standard_normal((n, 128)).astype(np.float32)
    labels = rng.integers(0, 40, n)
    g = build_graph(x, s, r, num_nodes=n)
    t0 = time.time()
    g = attach_band(g)
    t_band = time.time() - t0
    g = g.to(dev)
    sync(dev)
    f, b = g.band.fwd, g.band.bwd
    info = {"n": g.n_node, "e": g.n_edge, "n_pad": g.num_nodes_padded,
            "native_library_s": t_lib, "edges_s": t_edges, "cluster_order_s": t_order,
            "attach_band_s": t_band,
            "window": [f.window, b.window], "coverage": [f.coverage, b.coverage],
            "n_hub": [f.n_hub, b.n_hub], "n_hub_row": [f.n_hub_row, b.n_hub_row],
            "n_lo": [f.n_lo, b.n_lo],
            "hub_cols": [0 if x_.hub_ids is None else x_.hub_ids.numel() for x_ in (f, b)],
            "hub_rows": [0 if x_.hub_row_ids is None else x_.hub_row_ids.numel()
                         for x_ in (f, b)],
            "band_device_bytes": g.band.nbytes()}
    log(f"[band-graph] (fwd, bwd) {json.dumps(info)}")
    return g, labels, info


def phase_band_kernels(g):
    """K3 against its plain version, and the band Functions forward and
    backward on the kernels against the same Functions on the plain versions."""
    dev = g.senders.device
    chk = Checks("band kernels")
    gen = torch.Generator(device=dev).manual_seed(2)
    t = torch.tensor([0.1], device=dev)
    drop = tband.DropSpec(k0=-1640531527, k1=12345, thresh=tband.drop_thresh(0.3))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        x = g.x.to(dtype).contiguous()
        packed, _ = tband.softmax_table(x, t, 1e-7)  # the forward's [N_pad, 256] table
        q = torch.randn(g.num_nodes_padded, 128, device=dev, generator=gen).to(dtype)
        e3 = 0.0
        for name, table, band, spec, swap in (
                ("packed fwd table", packed, g.band.fwd, None, False),
                ("[N_pad,128] bwd band", q, g.band.bwd, None, False),
                ("packed fwd table, drop", packed, g.band.fwd, drop, False),
                ("[N_pad,128] bwd band, drop swap", q, g.band.bwd, drop, True)):
            got = tband.band_call(table, band, spec, swap)
            want = tband.band_call_plain(table, band, spec, swap)
            e3 = max(e3, chk.close(f"K3 {name} {tag}", got, want, **tol))
            del got, want
        tol_o = TOL_F32 if dtype == torch.float32 else TOL_BAND_BF16
        tol_b = TOL_F32 if dtype == torch.float32 else TOL_BWD_BF16
        for fn in ("band_spmm", "softmax_sg", "learn_t"):
            res = []
            for plain in (False, True):
                xx = x.detach().clone().requires_grad_(True)
                tt = t.clone().requires_grad_(fn == "learn_t")
                if fn == "band_spmm":
                    o = (tband.band_spmm_plain if plain else tband.band_spmm)(xx, g.band)
                else:
                    f = tband.band_softmax_agg_plain if plain else tband.band_softmax_agg
                    o = f(xx, g.band, tt, 1e-7, fn == "learn_t")
                (o.float() ** 2).sum().backward()
                res.append((o.detach(), xx.grad, tt.grad))
            chk.close(f"{fn} out {tag}", res[0][0], res[1][0], **tol_o)
            chk.close(f"{fn} dx {tag}", res[0][1], res[1][1], **tol_b)
            if fn == "learn_t":
                chk.close(f"{fn} dt {tag}", res[0][2], res[1][2], **TOL_DT[tag])
            del res
        errs[tag] = e3
        del x, packed, q
    sync(dev)
    chk.raise_if_failed()
    return errs


def phase_band_timing(g, errs, launches, iters):
    """K3 in bf16 on the packed forward table of the main path."""
    dev = g.senders.device
    chk = Checks("band timing")
    band = g.band.fwd
    n_pad, w = band.a.shape
    x = g.x.to(torch.bfloat16).contiguous()
    p, _ = tband.softmax_table(x, torch.tensor([0.1], device=dev), 1e-7)
    c = p.shape[1]
    k3_ms = time_fn(lambda: tband.band_call(p, band), dev, iters)
    k3_plain = time_fn(lambda: tband.band_call_plain(p, band), dev, 3)
    # yardstick (never called by the port): the in-band adjacency as one CSR
    # matrix [N_pad, N_pad] of the counts, built once, times the same table.
    # The CPU rehearsal runs it in float32: the CPU's sparse product has no
    # bfloat16.
    py = p if dev.type == "cuda" else p.float()
    nz = torch.nonzero(band.a)
    rows, cols = nz[:, 0], nz[:, 1]
    src = band.w_lo.long()[rows // tband.BN] + cols
    crow = torch.zeros(n_pad + 1, dtype=torch.long, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n_pad), 0)
    a_csr = torch.sparse_csr_tensor(crow, src, band.a[rows, cols].to(py.dtype),
                                    (n_pad, n_pad), check_invariants=True)
    lib_ms = time_fn(lambda: torch.sparse.mm(a_csr, py), dev, iters)
    chk.close("library yardstick sparse.mm vs K3", torch.sparse.mm(a_csr, py),
              tband.band_call(p, band), **TOL_LIBRARY)
    chk.raise_if_failed()
    nnz = int(rows.shape[0])
    # K3: A read once (int8), the table read once and out written once (bf16),
    # w_lo; one f32 multiply-add per (non-zero count, channel)
    k3_bound = bound(n_pad * w + 2 * n_pad * c * 2 + 4 * (n_pad // tband.BN), 2 * nnz * c)
    dense_ms = 2 * n_pad * w * c / BF16_TENSOR_FLOP_PER_S * 1e3
    log(f"[band-timing] K3 {k3_ms:.4f} ms, plain {k3_plain:.3f} ms, sparse.mm {lib_ms:.4f} "
        f"ms, bound {k3_bound[0]:.4f} ms ({k3_bound[1]}); A {n_pad}x{w} with {nnz} "
        f"non-zero counts ({100 * nnz / (n_pad * w):.2f}%); the dense product "
        f"2*N_pad*W*C at the bf16 tensor peak would take {dense_ms:.4f} ms (information)")
    return {"name": "K3 band", "route": "cuda", "source": f"{PKG}/csrc/band.cu",
            "replaces": "deep_gcns_torch_tpu/ops/band.py:425",
            "launches": launches["K3"], "max_abs_err": errs["bf16"], "ms": k3_ms,
            "plain_ms": k3_plain, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
            "library_ms": lib_ms}


def cluster_graph(n, deg, dev):
    """One ogbn-proteins cluster at `bench.py:221-231`'s shape: uniform random
    edges without added self-loops, 8-dim edge features in both edge orders,
    a species one-hot, 8 node features and 112 binary tasks, from seed 0.
    Returns the graph on ``dev`` and (species, node_feats, labels)."""
    t0 = time.time()
    rng = np.random.default_rng(0)
    g, _ = random_node_graph(rng, n, deg, 8, edge_dim=8, self_loops=False)
    n_pad = g.num_nodes_padded
    species = np.zeros((n_pad, 8), np.float32)
    species[np.arange(n), rng.integers(0, 8, n)] = 1.0
    node_feats = np.zeros((n_pad, 8), np.float32)
    node_feats[:n] = rng.standard_normal((n, 8))
    labels = np.zeros((n_pad, 112), np.float32)
    labels[:n] = rng.integers(0, 2, (n, 112))
    log(f"[cluster-graph] N={g.n_node} E={g.n_edge} N_pad={n_pad} "
        f"E_pad={g.num_edges_padded} built in {time.time() - t0:.1f}s")
    return g.to(dev), tuple(torch.from_numpy(a).to(dev) for a in (species, node_feats, labels))


def edge_inputs(g, c, dtype, gen):
    """x [N_pad, C] and edge embeddings in both edge orders as an edge encoder
    makes them: Linear(8, C) of the raw features, so the padded rows carry
    the bias (and enter `fused_cmax`'s edge maximum)."""
    dev = g.senders.device
    x = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen).to(dtype)
    w = torch.randn(8, c, device=dev, generator=gen) * 0.5
    b = torch.randn(c, device=dev, generator=gen) * 0.1
    return x, (g.edge_attr @ w + b).to(dtype), (g.edge_attr_csc @ w + b).to(dtype)


def phase_edge_kernels(g):
    """K2 with `ee` and K4 against their plain versions, and the fused
    Function with edge embeddings forward and backward on the kernels
    against the same Function on the plain versions."""
    dev = g.senders.device
    chk = Checks("edge kernels")
    gen = torch.Generator(device=dev).manual_seed(3)
    t = torch.tensor([1.0], device=dev)
    n_pad, n_edge = g.num_nodes_padded, g.n_edge
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        e2 = e4 = 0.0
        for c in (40, 64):
            x, ee, ee_csc = edge_inputs(g, c, dtype, gen)
            cmax = tsp.fused_cmax(x, t, 1e-7, ee)
            out, den = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
            out_p, den_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
            e2 = max(e2, chk.close(f"K2 ee out C={c} {tag}", out, out_p, **tol),
                     chk.close(f"K2 ee den C={c} {tag}", den, den_p, **tol))
            q = torch.randn(n_pad, c, device=dev, generator=gen).to(dtype)
            for gw in (False, True):
                qo = torch.cat([q, out_p], 1).contiguous() if gw else q
                args = (x, ee_csc, qo, g.csc_col_ptr, g.csc_receivers, t, cmax, 1e-7, gw)
                dx, dee, dt = tsp.softmax_bwd_csc(*args)
                dx_p, dee_p, dt_p = tsp.softmax_bwd_csc_plain(*args)
                name = f"K4 {'dt' if gw else 'no-dt'} C={c} {tag}"
                e4 = max(e4, chk.close(f"{name} dx", dx, dx_p, **tol),
                         chk.close(f"{name} dee", dee, dee_p, **tol))
                chk.close(f"{name} dee padding rows", dee[n_edge:], dee_p[n_edge:], 0.0, 0.0)
                if gw:
                    # the same float32 terms summed in another order
                    chk.close(f"{name} dt", dt, dt_p, **TOL_DT["f32"])
            co = torch.randn(n_pad, c, device=dev, generator=gen)
            for gw in (False, True):
                res = []
                for fn in (tsp.fused_softmax_gather_agg, tsp.fused_softmax_gather_agg_plain):
                    xx = x.detach().clone().requires_grad_(True)
                    ec = ee_csc.detach().clone().requires_grad_(True)
                    tt = t.clone().requires_grad_(gw)
                    o = fn(xx, g.senders, g.row_ptr, g.csc_receivers, g.csc_col_ptr, tt,
                           ee=ee, ee_csc=ec, eps=1e-7, grad_weights=gw)
                    (o.float() * co).sum().backward()
                    res.append((o.detach(), xx.grad, ec.grad, tt.grad))
                tol_b = (TOL_F32 if dtype == torch.float32 else
                         TOL_EE_LEARN_T_BF16 if gw else TOL_BWD_BF16)
                name = f"fused ee {'learn_t' if gw else 'softmax_sg'} C={c} {tag}"
                chk.close(f"{name} out", res[0][0], res[1][0], **tol)
                chk.close(f"{name} dx", res[0][1], res[1][1], **tol_b)
                chk.close(f"{name} d(ee_csc)", res[0][2], res[1][2], **tol_b)
                if gw:
                    chk.close(f"{name} dt", res[0][3], res[1][3], **TOL_DT[tag])
                del res
        errs[tag] = {"K2 ee": e2, "K4": e4}
    sync(dev)
    chk.raise_if_failed()
    return errs


def small_proteins_models():
    """(name, constructor) of a small RevGCN (the main path's config: group 2,
    softmax at a fixed t, layer norm, conv edge encoders) and a small
    DyResGEN (learned t, per-layer edge encoders), both at dropout 0."""
    return (
        ("RevGCN", lambda gen: RevGCN(RevGCNConfig(
            hidden_channels=32, num_tasks=12, num_layers=3, group=2, aggr="softmax",
            dropout=0.0), generator=gen)),
        ("DyResGEN", lambda gen: DeeperGCN(DeeperGCNConfig(
            in_channels=8, hidden_channels=32, num_tasks=12, num_layers=4, block="res+",
            aggr="softmax", learn_t=True, norm="layer", mlp_layers=1, dropout=0.0,
            edge_mode="per_layer", edge_feat_dim=8, use_one_hot_encoding=True,
            node_feat_dim=8, final_dropout=False), generator=gen)))


def phase_edge_agreement(dev):
    """The small proteins models on ``dev`` (K2 with `ee`, K4) against the
    same weights on the CPU (plain versions), in float32."""
    chk = Checks("edge agreement")
    rng = np.random.default_rng(4)
    n, e = 3000, 30000
    g = build_graph(None, rng.integers(0, n, e), rng.integers(0, n, e),
                    edge_attr=rng.random((e, 8)).astype(np.float32), num_nodes=n)
    n_pad = g.num_nodes_padded
    species = torch.from_numpy(np.eye(8, dtype=np.float32)[rng.integers(0, 8, n_pad)])
    nf = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32))
    co = torch.from_numpy(rng.standard_normal((n_pad, 12)).astype(np.float32))
    for name, make in small_proteins_models():
        outs = []
        for d in (dev, torch.device("cpu")):
            model = make(torch.Generator().manual_seed(0)).to(d)
            model.train()
            logits = model(species.to(d), g.to(d), node_feats=nf.to(d))
            (logits * co.to(d)).sum().backward()
            outs.append((logits.detach().cpu(),
                         {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
        # float32 through a few layers: summation order in K2/K4, the norms
        # and the matmuls, as in the DeeperGCN agreement phase
        chk.close(f"small {name} logits, card vs cpu", outs[0][0], outs[1][0], 1e-4, 1e-4)
        g_max = max(float(v.abs().max()) for v in outs[1][1].values())
        for k in outs[1][1]:
            chk.close(f"small {name} grad {k}", outs[0][1][k], outs[1][1][k], 1e-3, 1e-4,
                      ref_max=g_max)
    chk.raise_if_failed()


def free_memory(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)
    return 0


def phase_proteins_path(app, argv, g, feats, steps, expected, tag):
    """A proteins model built by ``app.build_model`` from the app's own flags,
    trained through ``app.train_step`` (one warm-up, ``steps`` timed) and
    run through ``app.predict`` once, with the launch counts set to 0 just
    before and read just after. ``expected(layers, steps)`` gives the counts
    a card run must show. Returns (info, a closure of one more train step)."""
    dev = g.senders.device
    species, node_feats, labels = feats
    args = app.get_args(argv + ["--device", dev.type])
    base = free_memory(dev)
    t0 = time.time()
    model = app.build_model(args, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("adam", model.parameters(), args.lr)
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    mask = g.node_mask

    def step():
        return app.train_step(model, opt, g, species, node_feats, labels, mask, gen)

    reset_launches()
    loss = step()  # warm-up
    sync(dev)
    losses, times = [float(loss)], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step()
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    logits = app.predict(model, g, species, node_feats)
    sync(dev)
    predict_s = time.perf_counter() - t0
    launches = read_launches()

    log(f"[{tag}] losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: loss is not finite")
    if logits.shape != (g.num_nodes_padded, 112) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: predict gave shape {tuple(logits.shape)} or "
                             "non-finite logits")
    want = expected(args.num_layers, steps) if dev.type == "cuda" else no_launches()
    log(f"[{tag}] launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != expected {want}")
    info = {"layers": args.num_layers, "params": n_params, "model_build_s": build_s,
            "step_ms_median": sorted(times)[len(times) // 2] * 1e3,
            "step_ms_all": [v * 1e3 for v in times], "predict_ms": predict_s * 1e3,
            "losses": losses, "launches": launches}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        info.update(peak_bytes=peak, peak_above_start_bytes=peak - base,
                    smi_after_steps=smi("clocks.sm,power.draw,temperature.gpu"))
    log(f"[{tag}] {json.dumps(info)}")
    return info, step


def rev_expected(group):
    """RevGCN: each train step runs every group's aggregation once in the
    forward and once in the backward's fused inverse+VJP (K2 with `ee`),
    plus its K4; `predict` runs the forward once. An inverse that re-ran
    the forward would show 3·L·G K2 launches a step."""
    def want(layers, steps):
        lg, n = layers * group, steps + 1
        out = no_launches()
        out.update({"K2 ee": 2 * lg * n + lg, "K4": lg * n})
        return out
    return want


def dyresgen_expected(layers, steps):
    out = no_launches()
    out.update({"K2 ee": layers * (steps + 2), "K4": layers * (steps + 1)})
    return out


def phase_rev_paths(g, feats, depths, steps):
    """RevGCN at the two depths (80 channels, group 2, bf16), a profile of a
    step at the smaller one, and the O(1)-memory check between them."""
    dev = g.senders.device
    infos = {}
    for layers in depths:
        argv = ["--num_layers", str(layers), "--compute_dtype", "bfloat16"]
        info, step = phase_proteins_path(ogbn_proteins_rev, argv, g, feats, steps,
                                         rev_expected(2), f"revgcn-{layers}")
        infos[layers] = info
        if layers == depths[0]:
            phase_profile(dev, step, steps=1, tag=f"revgcn-{layers}-profile")
        del step
    lo, hi = (infos[d] for d in depths)
    if dev.type != "cuda":
        log("[revgcn-memory] no device memory to measure on the CPU")
        return infos
    allowed = 16 * (hi["params"] - lo["params"]) + MEMORY_SLACK_BYTES
    growth = hi["peak_above_start_bytes"] - lo["peak_above_start_bytes"]
    log(f"[revgcn-memory] peak L={depths[0]} {lo['peak_bytes'] / 1e9:.4f} GB, "
        f"L={depths[1]} {hi['peak_bytes'] / 1e9:.4f} GB (ratio "
        f"{hi['peak_bytes'] / lo['peak_bytes']:.4f}); growth above the start "
        f"{growth / 1e6:.1f} MB, allowed {allowed / 1e6:.1f} MB (16 B x "
        f"{hi['params'] - lo['params']} more parameters + 256 MB)")
    if growth > allowed:
        raise AssertionError(f"revgcn-memory: the peak grew by {growth} bytes from "
                             f"L={depths[0]} to L={depths[1]}, more than {allowed}")
    return infos


def phase_proteins_app(dev, argv):
    """`apps/ogbn_proteins_rev.main` for one epoch: the synthetic data, the
    per-epoch partition on the host, ten cluster steps, the 5-part
    evaluation with `scatter_predictions` and ROC-AUC."""
    reset_launches()
    t0 = time.time()
    res = ogbn_proteins_rev.main(argv + ["--device", dev.type])
    wall = time.time() - t0
    launches = read_launches()
    info = {"loss": res["loss"], "results": res["results"],
            "partition_s": res["partition_s"], "wall_s": wall, "launches": launches}
    log(f"[app] {json.dumps(info)}")
    if not math.isfinite(res["loss"]) or not all(
            0.0 <= v <= 1.0 for v in res["results"].values()):
        raise AssertionError(f"app: loss {res['loss']} or ROC-AUC {res['results']} "
                             "out of range")
    if dev.type == "cuda" and (launches["K2 ee"] == 0 or launches["K4"] == 0):
        raise AssertionError(f"app: the edge kernels did not run: {launches}")


def phase_edge_timing(g, errs, launches, iters):
    """K2 with `ee` and K4 in bf16 at C=40 (a RevGCN group) on the cluster
    graph; K4 with dt at C=64 (DyResGEN) for information."""
    dev = g.senders.device
    gen = torch.Generator(device=dev).manual_seed(5)
    n_pad, e, e_pad = g.num_nodes_padded, g.n_edge, g.num_edges_padded
    t = torch.tensor([1.0], device=dev)
    rows, times = [], {}
    for c in (40, 64):
        x, ee, ee_csc = edge_inputs(g, c, torch.bfloat16, gen)
        cmax = tsp.fused_cmax(x, t, 1e-7, ee)
        qo = torch.randn(n_pad, c, device=dev, generator=gen).to(torch.bfloat16)
        out, _ = tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee)
        qo2 = torch.cat([qo, out], 1).contiguous()
        k2 = (lambda: tsp.softmax_agg(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee),
              lambda: tsp.softmax_agg_plain(x, g.senders, g.row_ptr, t, cmax, 1e-7, ee))
        k4 = [(lambda q=q, gw=gw: tsp.softmax_bwd_csc(
                   x, ee_csc, q, g.csc_col_ptr, g.csc_receivers, t, cmax, 1e-7, gw),
               lambda q=q, gw=gw: tsp.softmax_bwd_csc_plain(
                   x, ee_csc, q, g.csc_col_ptr, g.csc_receivers, t, cmax, 1e-7, gw))
              for q, gw in ((qo, False), (qo2, True))]
        for name, (fn, plain) in (("K2 ee", k2), ("K4", k4[0]), ("K4 dt", k4[1])):
            times[(name, c)] = (time_fn(fn, dev, iters), time_fn(plain, dev, 3))
        del x, ee, ee_csc, qo, qo2, out
    for (name, c), (ms, plain_ms) in times.items():
        log(f"[edge-timing] {name} C={c} bf16: {ms:.4f} ms, plain {plain_ms:.3f} ms")
    c = 40
    idx_b = 4 * e + 4 * (n_pad + 1) + 4 * c + 4
    # K2 with ee: x and ee read once, out and den written once (bf16), the
    # senders, row_ptr, cmax and t; per (edge, channel): add, max, add, mul,
    # sub, exp, mul, 2 roundings, 2 adds
    k2_bound = bound(n_pad * c * 2 + e * c * 2 + idx_b + 2 * n_pad * c * 2, 11 * e * c)
    # K4: x, ee_csc and qo read once, dx and dee (all E_pad rows) written
    # once; per (edge, channel): add, max, add, mul, sub, exp, mul, select,
    # rounding, add
    k4_bound = bound(n_pad * c * 2 + e * c * 2 + n_pad * c * 2 + idx_b
                     + n_pad * c * 2 + e_pad * c * 2, 10 * e * c)
    for name, src, line, b, key in (
            ("K2 softmax_agg ee", "softmax_agg.cu", "deep_gcns_torch_tpu/ops/spmm_pallas.py:322",
             k2_bound, "K2 ee"),
            ("K4 softmax_bwd_csc", "softmax_bwd_csc.cu",
             "deep_gcns_torch_tpu/ops/spmm_pallas.py:466", k4_bound, "K4")):
        ms, plain_ms = times[(key, c)]
        rows.append({"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                     "replaces": line, "launches": launches[key],
                     "max_abs_err": errs["bf16"][key], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
        log(f"[edge-timing] {name} C={c}: {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    log("[edge-timing] no single PyTorch call computes K2 with ee or K4: library_ms is null")
    return rows


def main(argv):
    rehearse = "--rehearse-cpu" in argv
    if not rehearse and not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
        return 1
    dev = torch.device("cpu" if rehearse else "cuda")
    n, layers, steps, iters = (2000, 3, 2, 2) if rehearse else (169_343, 28, 5, 50)
    t_all = time.time()
    info = phase_device(dev)
    g, labels = main_graph(n, dev)
    errs = phase_kernels(g)
    phase_agreement(dev)
    main_info, state = phase_main_path(g, labels, layers, steps)
    phase_profile(dev, arxiv_step(g, state))
    del state
    rows = phase_timing(g, errs, main_info["launches"], iters)
    del g
    log(f"[done] gather-route phases in {time.time() - t_all:.1f}s")

    gb, labels_b, _ = band_graph(n, dev)
    errs_b = phase_band_kernels(gb)
    band_info, state = phase_main_path(gb, labels_b, layers, steps, tag="band-main")
    phase_profile(dev, arxiv_step(gb, state), tag="band-profile")
    del state
    gather_info, _ = phase_main_path(gb.replace(band=None), labels_b, layers, 3,
                                     tag="band-graph-gather")
    log(f"[band-main] band/gather step ratio on the same graph: "
        f"{band_info['step_ms_median'] / gather_info['step_ms_median']:.4f} "
        f"({band_info['step_ms_median']:.3f} / {gather_info['step_ms_median']:.3f} ms)")
    k3_row = phase_band_timing(gb, errs_b, band_info["launches"], iters)
    del gb
    log(f"[done] band-route phases in {time.time() - t_all:.1f}s")

    gpr, feats = cluster_graph(*((800, 10) if rehearse else (13_000, 60)), dev)
    errs_e = phase_edge_kernels(gpr)
    phase_edge_agreement(dev)
    rev = phase_rev_paths(gpr, feats, (3, 5) if rehearse else (101, 1001), 2)
    dy_layers = 3 if rehearse else 112
    phase_proteins_path(ogbn_proteins, ["--learn_t", "--num_layers", str(dy_layers),
                                        "--compute_dtype", "bfloat16"],
                        gpr, feats, 3, dyresgen_expected, f"dyresgen-{dy_layers}")
    app_argv = ["--synthetic", "--synthetic_nodes", "3000" if rehearse else "132534",
                "--synthetic_degree", "8" if rehearse else "60", "--cluster_number", "10",
                "--num_layers", "3" if rehearse else "28", "--eval_parts", "5",
                "--compute_dtype", "bfloat16", "--epochs", "1"]
    phase_proteins_app(dev, app_argv)
    edge_rows = phase_edge_timing(gpr, errs_e, max(rev.values(),
                                                   key=lambda i: i["layers"])["launches"],
                                  iters)
    rows = rows[:2] + edge_rows[:1] + [k3_row] + edge_rows[1:]
    log(f"[done] all phases in {time.time() - t_all:.1f}s")
    if rehearse:
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    print(info["smi"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not os.path.isdir(os.path.join(ROOT, PKG, "csrc")):
        print(f"{PKG}/ not found beside chip_smoke.py: run it from a checkout of the "
              "repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from deep_gcns_torch_tpu_torch import native
    from deep_gcns_torch_tpu_torch.apps import ogbn_arxiv, ogbn_proteins, ogbn_proteins_rev
    from deep_gcns_torch_tpu_torch.data.reorder import cluster_order, permute_graph
    from deep_gcns_torch_tpu_torch.data.synthetic import (powerlaw_community_edges,
                                                          random_node_graph)
    from deep_gcns_torch_tpu_torch.graph import attach_band, build_graph
    from deep_gcns_torch_tpu_torch.models import (DeeperGCN, DeeperGCNConfig, RevGCN,
                                                  RevGCNConfig)
    from deep_gcns_torch_tpu_torch.ops import _build
    from deep_gcns_torch_tpu_torch.ops import band as tband
    from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
    from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

    sys.exit(main(sys.argv[1:]))
