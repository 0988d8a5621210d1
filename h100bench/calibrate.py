"""Readings of the numbers that decide ``correct``, for setting their limits:
the program's, its control's and the planted faults', over many seeds in one
process (a run's set-up is most of its cost). The benchmark's own runs do not
run this.

    python3 h100bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--modes program,control,half,answer,frozen] [--device cuda]

Per seed the inputs and the graph are built once; each mode builds its job,
draws the same weights and runs the warm-up period that a run's reference
follows; the reference runs once and every mode is read against it. One JSON
line a (seed, mode), then the range of each number by mode."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def read_seed(cell, seed: int, modes, device) -> dict:
    """{mode: readings} of one seed."""
    from h100bench import correct, faults, graphgen, harness

    inp = graphgen.make_inputs(cell.traffic, seed)
    data = harness.build_data(cell.traffic, inp, device, seed)
    recs, ref_inp = {}, None
    for mode in modes:
        cfg = faults.control_config(cell.config) if mode == "control" else None
        st = harness.setup_job(cell, data, device, seed, harness.Spans(), cfg=cfg,
                               fault=faults.get(mode))
        recs[mode] = st.record
        if ref_inp is None:
            ref_inp = harness.reference_inputs(inp, data, st)
        del st
        harness.free()
    n = data.n
    del data
    harness.free()
    t0 = time.perf_counter()
    ref = cell.reference.run(cell.config, ref_inp, device, steps=harness.REF_STEPS)
    ref_s = time.perf_counter() - t0
    out = {m: dict(correct.readings(r, ref, n), _diag=correct.diagnostics(r, ref, n))
           for m, r in recs.items()}
    out["_reference_s"] = ref_s
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--modes", default="program,control,half,answer")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch

    from h100bench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    cell = harness.resolve_cell(args.workload)
    modes = args.modes.split(",")
    table = {m: {} for m in modes}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = read_seed(cell, seed, modes, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for m in modes:
            for k, v in got[m].items():
                if not k.startswith("_"):
                    table[m].setdefault(k, []).append(v)
    for m in modes:
        print(json.dumps({"mode": m, "range": {k: [min(v), max(v)] for k, v in table[m].items()},
                          "all": table[m]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
