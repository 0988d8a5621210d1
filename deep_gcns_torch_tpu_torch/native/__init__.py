"""Native (C++) host library for the band route: reordering and band building.

Counterpart of `deep_gcns_torch_tpu/native/__init__.py:27-225`, with only the
entry points this slice needs: `rcm_order`, `cluster_order`, `band_windows`
and `band_counts`. The source is the port's copy of `graphbuild.cpp`. It is
compiled with `g++` at first use into the git-ignored
`deep_gcns_torch_tpu_torch/build/` (never beside the source), under a name
that carries a hash of the source, and bound with ctypes.

Every entry point returns None when the library cannot be built or loaded;
the callers then take their numpy versions, which are also the oracle of the
tests. `available()` says which path is active; `chip_smoke.py` requires the
native one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graphbuild.cpp")
BUILD = os.path.join(os.path.dirname(_HERE), "build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD, f"graphbuild-{digest}.so")


def _build(path: str) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial .so
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rcm_order.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p]
        lib.rcm_order.restype = None
        lib.cluster_order.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, i32p]
        lib.cluster_order.restype = None
        lib.band_windows.argtypes = [
            i32p, i64p, ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, i32p, u8p]
        lib.band_windows.restype = ctypes.c_int32
        lib.band_counts.argtypes = [
            i32p, i32p, u8p, ctypes.c_int64, i32p, ctypes.c_int32, ctypes.c_int32,
            i8p, i32p, i32p, ctypes.c_int64]
        lib.band_counts.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _ptr(a: np.ndarray, typ=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def rcm_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int
              ) -> Optional[np.ndarray]:
    """Reverse Cuthill-McKee permutation (perm[new_id] = old_id) of the
    symmetrized graph; None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    perm = np.empty(num_nodes, np.int32)
    lib.rcm_order(_ptr(senders), _ptr(receivers), len(senders), np.int32(num_nodes),
                  _ptr(perm))
    return perm


def cluster_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
                  cluster_size: int) -> Optional[np.ndarray]:
    """Greedy max-connectivity cluster ordering (perm[new_id] = old_id);
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    perm = np.empty(num_nodes, np.int32)
    lib.cluster_order(_ptr(senders), _ptr(receivers), len(senders), np.int32(num_nodes),
                      np.int32(cluster_size), _ptr(perm))
    return perm


def band_windows(s_sorted: np.ndarray, blk_start: np.ndarray, n_pad: int,
                 cands, target_cov: float, cost_div: int, align: int):
    """Window selection, per-block starts and in-band flags for the band
    builder (`ops/band._build_window`). Returns (window, w_lo, in_band) or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    s_sorted = np.ascontiguousarray(s_sorted, np.int32)
    blk_start = np.ascontiguousarray(blk_start, np.int64)
    cands = np.ascontiguousarray(cands, np.int32)
    nb = len(blk_start) - 1
    w_lo = np.empty(nb, np.int32)
    in_band = np.empty(len(s_sorted), np.uint8)
    window = lib.band_windows(
        _ptr(s_sorted), _ptr(blk_start, ctypes.c_int64), np.int32(nb), np.int32(n_pad),
        _ptr(cands), np.int32(len(cands)), ctypes.c_double(target_cov),
        ctypes.c_int64(cost_div), np.int32(align), ctypes.c_int64(nb * 128), _ptr(w_lo),
        _ptr(in_band, ctypes.c_uint8))
    return int(window), w_lo, in_band.astype(bool)


def band_counts(s_sorted: np.ndarray, r_sorted: np.ndarray, in_band: np.ndarray,
                w_lo: np.ndarray, window: int, bn: int, n_rows: int):
    """Fill the int8 band count matrix in one pass; saturated increments
    (> 127) come back as extra leftover edges. Returns (a_band, spill_s,
    spill_r), or None when the native library is unavailable or the spill
    overflows its buffer."""
    lib = _load()
    if lib is None:
        return None
    s_sorted = np.ascontiguousarray(s_sorted, np.int32)
    r_sorted = np.ascontiguousarray(r_sorted, np.int32)
    in_band = np.ascontiguousarray(in_band, np.uint8)
    w_lo = np.ascontiguousarray(w_lo, np.int32)
    a_band = np.zeros((n_rows, window), np.int8)
    cap = 1 << 20
    spill_s = np.empty(cap, np.int32)
    spill_r = np.empty(cap, np.int32)
    n = lib.band_counts(_ptr(s_sorted), _ptr(r_sorted), _ptr(in_band, ctypes.c_uint8),
                        len(s_sorted), _ptr(w_lo), np.int32(window), np.int32(bn),
                        _ptr(a_band, ctypes.c_int8), _ptr(spill_s), _ptr(spill_r),
                        ctypes.c_int64(cap))
    if n < 0:
        return None
    return a_band, spill_s[:n].copy(), spill_r[:n].copy()
