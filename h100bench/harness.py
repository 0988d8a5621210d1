"""The harness: finds a cell's files by name, builds its inputs through the
port's builders, drives the app's epoch loop and reads the per-layer
metrics. `run.py` is the command; `calibrate.py` reads the numbers that set
the limits of ``correct``; the tests drive the same functions on the CPU.

Nothing here imports JAX or the JAX package; the port is imported inside the
functions that drive it."""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from h100bench import graphgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one warm-up period before the window; the traced run profiles this many
# whole periods after its window
TRACE_PERIODS = 2
# the number of train steps the reference follows
REF_STEPS = 3


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module from a file of this folder, found by its name (once a
    process)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    path = os.path.abspath(path)
    name = "h100bench_file" + "".join(ch if ch.isalnum() else "_" for ch in path)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of `BENCHMARK.json`'s workloads with everything it names."""
    name: str
    chips: int
    config: Dict
    config_mod: object
    traffic: Dict
    reference: object
    limits: Dict
    per_layer: List[Dict] = field(default_factory=list)
    end_to_end: List[Dict] = field(default_factory=list)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve_cell(name: str, root: str = ROOT, bench: Optional[Dict] = None) -> Cell:
    """The workload ``name`` of `BENCHMARK.json` with every file it names:
    its configuration's sizes, adapter and reference, its traffic mix, the
    limits in ``cells/<name>.json``, and its metrics."""
    bench = bench or benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    here = os.path.join(root, os.path.basename(HERE))
    cfg_file = {c["name"]: c for c in bench["configs"]}[w["config"]]["file"]
    cell_file = os.path.join(here, "cells", f"{name}.json")

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(
        name=name, chips=int(w["chips"]), config=load_json(os.path.join(root, cfg_file)),
        config_mod=load_module(os.path.join(here, "configs", f"{w['config']}.py")),
        traffic=load_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        reference=load_module(os.path.join(here, "reference", f"{w['config']}.py")),
        limits=load_json(cell_file)["limits"] if os.path.exists(cell_file) else {},
        per_layer=[m for m in bench["per_layer"] if mine(m)],
        end_to_end=[m for m in bench["end_to_end"] if mine(m)])


# ---------------------------------------------------------------------------
# inputs and the graph
# ---------------------------------------------------------------------------

@dataclass
class Data:
    """The cell's graph on the device and its node data in the program's row
    order (``perm[row]`` is the node a row holds, None when not reordered)."""
    seed: int
    graph: object
    n: int
    n_pad: int
    in_dim: int
    labels: np.ndarray
    labels_dev: torch.Tensor
    splits: Dict[str, np.ndarray]
    perm: Optional[np.ndarray]
    build_s: float

    def mask(self, split: str) -> torch.Tensor:
        m = torch.zeros(self.n_pad, dtype=torch.bool)
        m[torch.from_numpy(np.asarray(self.splits[split]))] = True
        return m.to(self.labels_dev.device)


def build_data(traffic: Dict, inp: Dict, device: torch.device, seed: int) -> Data:
    """The port's builders on the generated arrays (`graph.to_undirected`,
    `add_self_loops`, `build_graph`, and as the traffic asks
    `data.reorder.cluster_order` or `rcm_order` and `graph.attach_band`),
    then the graph on the device; ``build_s`` is the host clock of that.
    The graph is always made undirected with one self-loop a node, as the
    reference makes it (`reference/plain.graph_edges`)."""
    from deep_gcns_torch_tpu_torch.data.reorder import (cluster_order, invert_permutation,
                                                        permute_graph, rcm_order)
    from deep_gcns_torch_tpu_torch.graph import (add_self_loops, attach_band, build_graph,
                                                 to_undirected)

    t0 = time.perf_counter()
    n = inp["n"]
    s, r = inp["senders"], inp["receivers"]
    s, r = add_self_loops(*to_undirected(s, r), n)
    x, labels, splits, perm = inp["x"], np.asarray(inp["labels"]), inp["splits"], None
    reorder = traffic.get("reorder", "none")
    if reorder != "none":
        perm = rcm_order(s, r, n) if reorder == "rcm" else cluster_order(s, r, n)
        perm = np.asarray(perm)
        s, r, x, labels = permute_graph(perm, s, r, x, labels)
        inv = invert_permutation(perm)
        splits = {k: inv[np.asarray(v)] for k, v in splits.items()}
    g = build_graph(x, s, r, num_nodes=n)
    if traffic.get("band", "off") == "auto":
        g = attach_band(g)
    g = g.to(device)
    lab = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    lab[:n] = torch.from_numpy(np.asarray(labels))
    lab = lab.to(device)
    _sync(device)
    return Data(seed=seed, graph=g, n=n, n_pad=g.num_nodes_padded, in_dim=int(x.shape[1]),
                labels=np.asarray(labels), labels_dev=lab, splits=splits, perm=perm,
                build_s=time.perf_counter() - t0)


def make_weights(cfg_mod, model: torch.nn.Module, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The configuration's init drawn on the device from ``seed``, loaded
    into ``model``; returns a host copy for the reference."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(graphgen.sub_seed(seed, 1))
    w = cfg_mod.init_weights(shapes, gen)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w[k])
    return {k: v.detach().cpu() for k, v in w.items()}


# ---------------------------------------------------------------------------
# the loop: a frozen copy of the apps' epoch loop
# ---------------------------------------------------------------------------

class Spans:
    """Host spans of the loop: while ``annotate`` is on (the profiled
    periods) each span's name and wall-clock interval (``time.time_ns``, the
    profiler's clock) is kept, to label the device's idle gaps; while
    ``events`` is on, CUDA events go around each evaluation."""

    def __init__(self):
        self.annotate = False
        self.events = False
        self.eval_events: List = []
        self.host: List = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        ev = None
        if self.events and name == "predict":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.time_ns() if self.annotate else 0
        yield
        if self.annotate:
            self.host.append((t0, time.time_ns(), name))
        if ev is not None:
            ev[1].record()
            self.eval_events.append(ev)


def run_epochs(job, start: int, done: Callable[[int], bool], eval_every: int, spans: Spans,
               after_epoch: Optional[Callable] = None) -> Dict:
    """The apps' `main` loop: a train step every epoch and, every
    ``eval_every``-th, `predict`, its host copy, the accuracies and the host
    read of the loss. Runs whole periods from ``start`` (a multiple of
    ``eval_every``) until ``done(next_epoch)``; ends in a device sync.
    ``after_epoch(epoch, loss, pred)`` sees each epoch (``pred`` on
    evaluated epochs, else None). Returns the epochs run and the losses
    read."""
    epoch, read, nonfinite = start, [], 0
    while True:
        with spans("host"):
            a = job.host(epoch)
        with spans("train_step"):
            loss_t = job.train(a)
        pred = None
        if epoch % eval_every == 0:
            with spans("predict"):
                out = job.predict()
            with spans("loss_read"):
                pred = out.cpu().numpy()
                job.accuracies(pred)
                loss = float(loss_t)
            read.append(loss)
            nonfinite += not math.isfinite(loss)
        if after_epoch is not None:
            after_epoch(epoch, loss_t, pred)
        epoch += 1
        if epoch % eval_every == 0 and done(epoch):
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"epochs": epoch - start, "losses": read, "nonfinite": nonfinite}


# ---------------------------------------------------------------------------
# set-up: the job, its weights and the warm-up the reference follows
# ---------------------------------------------------------------------------

def first_grad_norms(opt: torch.optim.Optimizer, named) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient norm as the optimizer got it, from its state
    after one step: Adam's exp_avg = (1 - beta1)·g, RMSprop's square_avg =
    (1 - alpha)·g²; 0 for a leaf the optimizer never stepped."""
    group_of = {id(p): grp for grp in opt.param_groups for p in grp["params"]}
    out = {}
    for k, p in named:
        st, grp = opt.state.get(p, {}), group_of[id(p)]
        if "exp_avg" in st:
            out[k] = st["exp_avg"].norm() / (1 - grp["betas"][0])
        elif "square_avg" in st:
            out[k] = torch.sqrt(st["square_avg"].sum() / (1 - grp["alpha"]))
        else:
            out[k] = torch.zeros((), device=p.device)
    return out


@dataclass
class Setup:
    job: object
    weights: Dict[str, torch.Tensor]
    drop_seed: int
    record: Dict
    # host-clock seconds of building the job with its weights, and of the
    # warm-up period
    job_s: float = 0.0
    warmup_s: float = 0.0


def setup_job(cell: Cell, data: Data, device: torch.device, seed: int, spans: Spans,
              cfg: Optional[Dict] = None, fault: Optional[Callable] = None) -> Setup:
    """Build the job, draw its weights, and run the warm-up: the first whole
    period through the window's own loop. On the way it records what the
    reference checks: the losses of the first ``REF_STEPS`` steps, the first
    gradient norms (from the optimizer's state after step 1), each leaf's
    change after step ``REF_STEPS``, and the evaluation after step 1.
    ``fault`` (tests and calibration) breaks the job underneath."""
    cfg = cfg or cell.config
    t0 = time.perf_counter()
    drop_seed = graphgen.sub_seed(seed, 2)
    job = cell.config_mod.Job(cfg, data, device, drop_seed)
    weights = make_weights(cell.config_mod, job.model, seed, device)
    if fault is not None:
        fault(job)
    named = list(job.model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in named}
    rec: Dict = {"losses": []}

    def after(epoch, loss, pred):
        if epoch < REF_STEPS:
            rec["losses"].append(loss)
        if epoch == 0:
            rec["grad_norms"] = first_grad_norms(job.opt, named)
            rec["eval_pred"] = pred
        if epoch == REF_STEPS - 1:
            rec["change_norms"] = {k: (p.detach() - p0[k]).norm() for k, p in named}

    _sync(device)
    t1 = time.perf_counter()
    run_epochs(job, 0, lambda e: True, int(cell.traffic.get("eval_every", 5)), spans, after)
    t2 = time.perf_counter()
    rec["losses"] = [float(v) for v in rec["losses"]]
    rec["grad_norms"] = {k: float(v) for k, v in rec["grad_norms"].items()}
    rec["change_norms"] = {k: float(v) for k, v in rec["change_norms"].items()}
    rec["label_splits"] = list(getattr(job, "label_splits", [])[:REF_STEPS])
    return Setup(job=job, weights=weights, drop_seed=drop_seed, record=rec, job_s=t1 - t0,
                 warmup_s=t2 - t1)


def reference_inputs(inp: Dict, data: Data, st: Setup) -> Dict:
    """What the reference is handed: the raw inputs, the initial weights, the
    seeds of the random stream and the label splits the benchmark drew, and
    the program's row layout (the padded row count and the reorder)."""
    return {"n": data.n, "n_pad": data.n_pad, "senders": inp["senders"],
            "receivers": inp["receivers"], "perm": data.perm,
            "x": inp["x"] if data.perm is None else inp["x"][data.perm],
            "labels": data.labels, "splits": data.splits, "weights": st.weights,
            "drop_seed": st.drop_seed, "label_splits": st.record["label_splits"]}


def free():
    """Collect what the caller dropped and return its memory to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# counters of the program
# ---------------------------------------------------------------------------

def read_counters() -> Dict[str, int]:
    """The port's kernel-launch counters and its route misses."""
    from deep_gcns_torch_tpu_torch.ops import band, blocksparse, gat_dense, route_misses, spmm_cuda

    launches = {
        "K1": spmm_cuda.csr_seg_sum.launches, "K2": spmm_cuda.softmax_agg.launches,
        "K2ee": spmm_cuda.softmax_agg.launches_ee,
        "K2msgs": spmm_cuda.softmax_agg_msgs.launches, "K3": band.band_call.launches,
        "K4": spmm_cuda.softmax_bwd_csc.launches, "K5": spmm_cuda.gat_fwd.launches,
        "K6": spmm_cuda.gat_bwd_csc.launches, "K7": gat_dense.win_fused.launches,
        "K8": gat_dense.win_der.launches, "K9": gat_dense.win_dsend.launches,
        "K10": blocksparse.block_spmm.launches}
    return {"launches": launches,
            "route_misses": int(sum(route_misses.fastpath_misses().values()))}


# ---------------------------------------------------------------------------
# the per-layer metrics
# ---------------------------------------------------------------------------

@dataclass
class Context:
    """What the metric readers read: the window's epochs and host-clock length,
    the set-up's length and host build, the window's memory peak, the
    CUDA-event spans (ms), the counters over the window, the trace of the
    profiled periods and the configuration's counts."""
    cell: Cell
    graph: object
    data_n: int
    data_e: int
    epochs: int
    window_s: float
    setup_s: float
    window_peak_bytes: int
    host_build_s: float
    eval_ms: List[float]
    fwd_ms: List[float]
    bwd_ms: List[float]
    step_ms: List[float]
    counters0: Dict
    counters1: Dict
    trace: Optional[object]
    trace_steps: int
    trace_predicts: int

    def per_epoch(self, delta: float) -> Optional[float]:
        return delta / self.epochs if self.epochs else None

    def roofline(self, kernel: str) -> Optional[float]:
        """The kernel's share of its roofline over the profiled periods: the
        least time of the calls that the steps and evaluations there make
        (the configuration's kernel calls, the cost file's operations and
        bytes) over the kernel's device time in the trace. None where the
        trace shows no call of it."""
        from h100bench import peaks

        if self.trace is None:
            return None
        total_s, count = self.trace.kernel(load_module(
            os.path.join(HERE, "costs", f"{kernel}.py")).NAME)
        if count == 0 or total_s <= 0:
            return None
        cost = load_module(os.path.join(HERE, "costs", f"{kernel}.py")).cost
        calls = self.cell.config_mod.kernel_calls(self.cell.config, self.graph)
        shapes = (calls["train_step"].get(kernel, []) * self.trace_steps
                  + calls["predict"].get(kernel, []) * self.trace_predicts)
        if len(shapes) != count:
            log(f"[roofline] {kernel}: the trace has {count} calls, the configuration's "
                f"arithmetic {len(shapes)}: no reading")
            return None
        least = sum(peaks.least_seconds(*cost(s)) for s in shapes)
        return 100.0 * least / total_s

    def mfu(self) -> Optional[float]:
        """Model FLOPs of the profiled periods over (their length x the
        float32 peak), in %."""
        from h100bench import peaks

        if self.trace is None or self.trace.window_s <= 0:
            return None
        f = self.cell.config_mod.flops(self.cell.config, self.data_n, self.data_e)
        work = f["train_step"] * self.trace_steps + f["predict"] * self.trace_predicts
        return 100.0 * work / (self.trace.window_s * peaks.F32_FLOP_PER_S)


def read_metrics(metrics: List[Dict], ctx: Context) -> Dict[str, Dict]:
    """Each metric from its own reader (`metrics/<name>.py`); a reader that
    finds nothing returns None, and the metric is left out."""
    out = {}
    for m in metrics:
        v = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py")).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


class LayerEvents:
    """CUDA events at the model's forward pre- and post-hooks (training
    forwards only) and the optimizer's step pre- and post-hooks: per step the
    forward, the backward (forward's end to the step's start: the loss, the
    backward and any recomputation) and the optimizer step, in ms."""

    def __init__(self, model: torch.nn.Module, opt: torch.optim.Optimizer):
        self.model, self.rows, self.cur, self.on = model, [], None, False
        self.handles = [model.register_forward_pre_hook(self._fwd_pre),
                        model.register_forward_hook(self._fwd_post),
                        opt.register_step_pre_hook(self._opt_pre),
                        opt.register_step_post_hook(self._opt_post)]

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _fwd_pre(self, mod, args):
        if self.on and mod.training:
            self.cur = {"fwd0": self._event()}

    def _fwd_post(self, mod, args, out):
        if self.on and mod.training and self.cur is not None:
            self.cur["fwd1"] = self._event()

    def _opt_pre(self, opt, args, kwargs):
        if self.on and self.cur is not None and "fwd1" in self.cur:
            self.cur["opt0"] = self._event()

    def _opt_post(self, opt, args, kwargs):
        if self.on and self.cur is not None and "opt0" in self.cur:
            self.cur["opt1"] = self._event()
            self.rows.append(self.cur)
        self.cur = None

    def remove(self):
        for h in self.handles:
            h.remove()

    def ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {"fwd": [r["fwd0"].elapsed_time(r["fwd1"]) for r in self.rows],
                "bwd": [r["fwd1"].elapsed_time(r["opt0"]) for r in self.rows],
                "step": [r["opt0"].elapsed_time(r["opt1"]) for r in self.rows]}
