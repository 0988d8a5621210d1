"""Experiment logging (counterpart of `deep_gcns_torch_tpu/utils/logger.py`),
after the reference's conventions:

* experiment directories `{root}/{name}-{timestamp}-{uuid}` with an optional
  snapshot of the source (`examples/sem_seg_dense/config.py:100-125`);
* Python logging to `log.txt` and to the console (`config.py:135-159`);
* scalars and histograms as JSON lines (`scalars.jsonl`), the headless
  stand-in for the reference's TensorBoard writer;
* point-cloud summaries as PLY files (`log_mesh`, the stand-in for the
  reference's `mesh_summary`);
* the CSV dump of the best result (`utils/logger.py:6-14`).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import time
import uuid
from typing import Optional

import numpy as np

LOGGER_NAME = "deep_gcns_torch_tpu_torch"


def create_exp_dir(root: str, name: str, snapshot_src: Optional[str] = None) -> str:
    """Create `{root}/{name}-{timestamp}-{uuid}`, with a copy of the `.py`
    files under ``snapshot_src`` in `code_snapshot/`."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    exp = os.path.join(root, f"{name}-{stamp}-{uuid.uuid4().hex[:8]}")
    os.makedirs(exp, exist_ok=True)
    if snapshot_src:
        dst = os.path.join(exp, "code_snapshot")
        for f in glob.glob(os.path.join(snapshot_src, "**", "*.py"), recursive=True):
            out = os.path.join(dst, os.path.relpath(f, snapshot_src))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            shutil.copyfile(f, out)
    return exp


def setup_logging(exp_dir: str, level=logging.INFO) -> logging.Logger:
    """The package logger, writing to `{exp_dir}/log.txt` and the console."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (logging.FileHandler(os.path.join(exp_dir, "log.txt")), logging.StreamHandler()):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class ScalarLogger:
    """Append-only JSON-lines summaries in `{exp_dir}/scalars.jsonl`."""

    def __init__(self, exp_dir: str):
        self.exp_dir = exp_dir
        self.path = os.path.join(exp_dir, "scalars.jsonl")

    def log(self, step: int, **scalars):
        with open(self.path, "a") as f:
            for k, v in scalars.items():
                f.write(json.dumps({"step": int(step), "tag": k, "value": float(v)}) + "\n")

    def log_histogram(self, step: int, tag: str, values, bins: int = 30):
        """Bucket counts, edges and moments of ``values`` as one line."""
        v = np.asarray(values).reshape(-1).astype(np.float64)
        counts, edges = np.histogram(v, bins=bins)
        rec = {"step": int(step), "tag": tag, "kind": "histogram",
               "min": float(v.min()) if v.size else 0.0,
               "max": float(v.max()) if v.size else 0.0,
               "mean": float(v.mean()) if v.size else 0.0,
               "std": float(v.std()) if v.size else 0.0,
               "counts": counts.tolist(), "edges": np.round(edges, 6).tolist()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_mesh(self, step: int, tag: str, points, colors=None, labels=None) -> str:
        """Write the point cloud (coloured, or by ``labels`` through the
        palette) to `{exp}/meshes/{tag}_{step}.ply`; returns the path."""
        from .pc_export import write_ply

        path = os.path.join(self.exp_dir, "meshes", f"{tag}_{step}.ply")
        return write_ply(path, points, colors=colors, labels=labels)


def save_best_result(csv_path: str, name: str, **metrics):
    """Append one row (a header first in a new file)."""
    new = not os.path.exists(csv_path)
    with open(csv_path, "a") as f:
        if new:
            f.write("name," + ",".join(metrics.keys()) + "\n")
        f.write(name + "," + ",".join(str(v) for v in metrics.values()) + "\n")
