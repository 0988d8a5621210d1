"""Run one cell of the port's benchmark once and print one JSON line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: the cell's inputs from ``--seed`` (`graphgen.py`), the graph
through the port's builders, the job of the configuration (`configs/`), its
weights drawn on the device, a warm-up period that the plain reference later
follows, the window of the app's epoch loop for ``--seconds`` (to the end of
the first whole evaluation period after them), and with ``--trace 1`` the
per-layer readings and a profiled stretch of whole periods. Then the
program's state is freed, the reference (`reference/`) runs, and the
numbers that decide ``correct`` are printed beside their limits, last on
standard error and last in the result line.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result: it never falls back to the CPU. It exits
with code 3 and no result if JAX, flax or the JAX package is loaded once the
window has closed."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache a run could write, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)
if __name__ == "__main__":
    # Python's bytecode as well: where the environment writes none, every
    # process compiles each imported module from source again, seconds of
    # set-up that swing with the host's pace
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "deep_gcns_torch_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def drive(cell, seed: int, seconds: float, trace: bool, device, t0: float,
          phases: dict | None = None) -> dict:
    """One run of ``cell`` on ``device`` (the tests pass the CPU); returns
    the result's fields. ``phases`` holds the host-clock seconds of the
    set-up's steps before this call; the steps of this one are added and the
    whole set-up's split is logged before the window."""
    import torch

    from h100bench import correct, graphgen, harness
    from h100bench import trace as tr

    cuda = device.type == "cuda"
    every = int(cell.traffic.get("eval_every", 5))
    phases = dict(phases or {})
    t = time.perf_counter()
    inp = graphgen.make_inputs(cell.traffic, seed)
    phases["inputs"] = time.perf_counter() - t
    data = harness.build_data(cell.traffic, inp, device, seed)
    phases["build"] = data.build_s
    spans = harness.Spans()
    st = harness.setup_job(cell, data, device, seed, spans)
    phases["job"], phases["warmup"] = st.job_s, st.warmup_s
    job = st.job
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    layer = None
    if trace and cuda:
        layer = harness.LayerEvents(job.model, job.opt)
        layer.on = spans.events = True
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    harness.log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
                + f"; total {time.perf_counter() - t0:.3f} s")
    c0 = harness.read_counters()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    res = harness.run_epochs(job, every, lambda e: time.perf_counter() >= deadline, every, spans)
    window_s = time.perf_counter() - t_start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    c1 = harness.read_counters()
    spans.events = False
    ms = {"fwd": [], "bwd": [], "step": []}
    eval_ms = []
    if layer is not None:
        layer.on = False
        ms = layer.ms()
        eval_ms = [a.elapsed_time(b) for a, b in spans.eval_events]
        layer.remove()
    summary, steps, predicts = None, 0, 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        start = every * (1 + res["epochs"] // every)
        count = [0]

        def periods_done(_):
            count[0] += 1
            return count[0] >= harness.TRACE_PERIODS
        spans.annotate = True
        with profile(activities=acts) as prof:
            r2 = harness.run_epochs(job, start, periods_done, every, spans)
        spans.annotate = False
        summary = tr.summarize(prof.profiler.kineto_results.events(), spans.host)
        steps, predicts = r2["epochs"], r2["epochs"] // every
        harness.log(f"[trace] {steps} steps, {predicts} evaluations, window "
                    f"{summary.window_s:.4f} s, busy {summary.busy_s:.4f} s, first device "
                    f"event {summary.first_device_s} s after the first host span")
        del prof
    ctx = harness.Context(
        cell=cell, graph=data.graph, data_n=data.n, data_e=data.graph.n_edge,
        epochs=res["epochs"], window_s=window_s, setup_s=t_start - t0,
        window_peak_bytes=window_peak, host_build_s=data.build_s, eval_ms=eval_ms,
        fwd_ms=ms["fwd"], bwd_ms=ms["bwd"], step_ms=ms["step"], counters0=c0, counters1=c1,
        trace=summary, trace_steps=steps, trace_predicts=predicts)
    metrics = harness.read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    n, rec = data.n, st.record
    ref_inp = harness.reference_inputs(inp, data, st)
    del ctx, job, st, data, layer
    harness.free()
    ref = cell.reference.run(cell.config, ref_inp, device, steps=harness.REF_STEPS)
    values = correct.readings(rec, ref, n)
    out = {"correct": bool(correct.judge(values, cell.limits) and res["nonfinite"] == 0),
           "attempted": res["epochs"], "failed": res["nonfinite"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["checks"] = correct.checks(values, cell.limits)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)

    import torch

    from h100bench import harness

    cell = harness.resolve_cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA card: this benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} cards, found "
                    f"{torch.cuda.device_count()}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    phases = {"imports": time.perf_counter() - T0}
    t = time.perf_counter()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    phases["cuda_init"] = time.perf_counter() - t
    out = drive(cell, args.seed % (1 << 64), args.seconds, bool(args.trace), device, T0,
                phases)
    found = forbidden_modules()
    if found:
        harness.log(f"forbidden modules loaded: {found}")
        return 3
    for k, v in out["checks"].items():
        harness.log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
