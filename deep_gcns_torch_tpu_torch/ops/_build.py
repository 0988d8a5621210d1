"""Build and bind the port's CUDA kernels (takes the place of the Mosaic
compilation that `pl.pallas_call` does in the JAX package).

Each `csrc/*.cu` source is compiled on first use by its own `nvcc` process
(all started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

and bound with `ctypes`. The library name carries a hash of the sources, so a
changed source is rebuilt and a stale library is never loaded. The `build/`
directory sits beside `csrc/` and is listed in `.gitignore`.

Nothing here runs at import time, so a machine with no `nvcc` and no card
imports the package; only a CUDA tensor reaches `library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("seg_sum", "softmax_agg", "band", "softmax_bwd_csc", "gat_fwd", "gat_bwd_csc",
           "win_fused", "win_der", "win_dsend", "blocksparse", "batch_norm_act")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every C entry point, by source
_SIGNATURES = {
    # src, idx, ptr, out; n_rows, C, vec, w, G, stream
    "seg_sum": {name: [_P] * 4 + [_I] * 5 + [_P]
                for name in ("dgc_seg_sum_f32", "dgc_seg_sum_bf16")},
    # x, ee, senders, row_ptr, order, t, out, lse; n_rows, n_split, C, w, G;
    # eps, vec, stream; the message form: msgs, row_ptr, t, out, lse; n_rows,
    # C, w, G, vec, stream
    "softmax_agg": {**{name: [_P] * 8 + [_I] * 5 + [_F, _I, _P]
                       for name in ("dgc_softmax_agg_f32", "dgc_softmax_agg_bf16")},
                    **{name: [_P] * 5 + [_I] * 5 + [_P]
                       for name in ("dgc_softmax_agg_msgs_f32", "dgc_softmax_agg_msgs_bf16")}},
    # x, ee, qo, lse, col_ptr, order, receivers, t, dx, dee, dt_part; n_rows,
    # C, e_pad, w, G; eps, grad_weights, vec, stream
    "softmax_bwd_csc": {name: [_P] * 11 + [_I, _I, _L, _I, _I, _F, _I, _I, _P]
                        for name in ("dgc_softmax_bwd_csc_f32", "dgc_softmax_bwd_csc_bf16")},
    "band": {name: [_P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _I, _I, _P]
             for name in ("dgc_band_f32", "dgc_band_bf16")},
    # tab, senders, recv, row_ptr, cmax, out; n_rows, P, D, H; slope, vec,
    # nch, w, G, stream
    "gat_fwd": {name: [_P] * 6 + [_I] * 4 + [_F, _I, _I, _I, _I, _P]
                for name in ("dgc_gat_fwd_f32", "dgc_gat_fwd_bf16")},
    # tab, g, col_ptr, recv, keep, cmax, dtab; n_rows, P, D, H; slope, vec,
    # nch, w, G, stream
    "gat_bwd_csc": {name: [_P] * 7 + [_I] * 4 + [_F, _I, _I, _I, _I, _P]
                    for name in ("dgc_gat_bwd_csc_f32", "dgc_gat_bwd_csc_bf16")},
    # K7-K9: the band's 4 pointers, the [N, H] and [N, H*D] tables and the
    # outputs, then n_rows, W, n_hub, H, D, the slope, the drop key and
    # threshold, vec, nch, the list size and the stream
    **{src: {f"dgc_{src}_{t}": [_P] * n_ptr + [_I] * 5 + [_F, _U, _U, _I, _I] + [_I] * n_lay
             + [_P] for t in ("f32", "bf16")}
       for src, n_ptr, n_lay in (("win_fused", 11, 2), ("win_der", 11, 2),
                                 ("win_dsend", 12, 2))},
    "blocksparse": {name: [_P] * 5 + [_I, _I, _P] for name in ("dgc_bsp_f32", "dgc_bsp_bf16")},
    # K11 forward: x, sx, mask, w, b, mult, sm, mode, div, eps, y, mu, rstd,
    # cnt, part, run_mean, run_var, momentum, keep_f; n_rows, C, vec, stream.
    # Evaluation: x, sx, run_mean, run_var, w, b, eps, y, rstd; n_rows, C,
    # vec, stream.  Backward: x, sx, dy, sdy, mask, w, b, mult, sm, mode, div,
    # mu, rstd, cnt, dx, dw, db, part; n_rows, C, vec, stream
    "batch_norm_act": {
        "dgc_bn_act_fwd_f32": [_P, _L] + [_P] * 4 + [_L, _I, _F, _F] + [_P] * 7 + [_F, _F]
        + [_I] * 3 + [_P],
        "dgc_bn_act_eval_f32": [_P, _L] + [_P] * 4 + [_F, _P, _P] + [_I] * 3 + [_P],
        "dgc_bn_act_bwd_f32": [_P, _L, _P, _L] + [_P] * 4 + [_L, _I, _F] + [_P] * 7 + [_I] * 3
        + [_P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine "
                           "with the card (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Sequence[str] = SOURCES, verbose: bool = False) -> Dict[str, str]:
    """Compile the named sources that have no current library, one `nvcc` per
    source, in parallel. Returns {name: library path}; raises on any failure
    with the compiler's output."""
    os.makedirs(BUILD, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {n}.cu]\n{log}", flush=True)
        os.replace(tmp, paths[n])  # atomic: concurrent builders never see a partial .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The bound library of one source, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
