"""Headless point-cloud visualization export (the port's copy of
`deep_gcns_torch_tpu/utils/pc_export.py:26-70`).

Replaces the reference's interactive VTK viewer (`utils/pc_viz.py:24-274`) with
PLY/OBJ writers usable in this headless environment: colored point clouds, label
colorization, and the part-segmentation prediction-vs-ground-truth comparison
(`visualize_part_seg` analog) as side-by-side clouds.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# distinct colors for up to 20 classes (tab20-like)
_PALETTE = np.array([
    [ 31, 119, 180], [255, 127,  14], [ 44, 160,  44], [214,  39,  40],
    [148, 103, 189], [140,  86,  75], [227, 119, 194], [127, 127, 127],
    [188, 189,  34], [ 23, 190, 207], [174, 199, 232], [255, 187, 120],
    [152, 223, 138], [255, 152, 150], [197, 176, 213], [196, 156, 148],
    [247, 182, 210], [199, 199, 199], [219, 219, 141], [158, 218, 229],
], np.uint8)


def label_colors(labels: np.ndarray) -> np.ndarray:
    return _PALETTE[np.asarray(labels) % len(_PALETTE)]


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None,
              labels: Optional[np.ndarray] = None) -> str:
    """Write an ascii PLY point cloud; `labels` are colorized via the palette."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is None and labels is not None:
        colors = label_colors(labels)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            colors = np.asarray(colors, np.uint8).reshape(-1, 3)
            for p, c in zip(points, colors):
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
    return path


def export_part_seg_comparison(out_dir: str, points: np.ndarray,
                               pred: np.ndarray, label: np.ndarray,
                               name: str = "shape") -> Sequence[str]:
    """Prediction vs ground truth side by side (`utils/pc_viz.py::visualize_part_seg`
    analog): writes `{name}_pred.ply` and `{name}_gt.ply` with a shared palette,
    plus `{name}_err.ply` highlighting wrong points in red."""
    paths = [
        write_ply(os.path.join(out_dir, f"{name}_pred.ply"), points, labels=pred),
        write_ply(os.path.join(out_dir, f"{name}_gt.ply"), points, labels=label),
    ]
    correct = (np.asarray(pred) == np.asarray(label))[:, None]
    err = np.where(correct, np.array([[180, 180, 180]], np.uint8),
                   np.array([[255, 0, 0]], np.uint8)).astype(np.uint8)
    paths.append(write_ply(os.path.join(out_dir, f"{name}_err.ply"), points,
                           colors=err))
    return paths
