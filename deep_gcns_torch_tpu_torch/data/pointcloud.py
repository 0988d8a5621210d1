"""Point-cloud data: augmentation, batching, the h5 loaders and the synthetic
stand-ins (the port's copy of `deep_gcns_torch_tpu/data/pointcloud.py:25-199`,
numpy only, so that both packages draw the same arrays from one
`np.random.Generator`).

* ModelNet40 h5 (`examples/modelnet_cls/data.py:9-73`), S3DIS h5 room blocks
  and PartNet's sem_seg_h5 files; the loaders import `h5py` only when called
  and raise a clear error without it. The data is not in the repository:
  the apps run on ``--synthetic`` data until it is.
* augmentations: random rotate / scale + shift / jitter
  (`utils/data_util.py:63-95`, `examples/modelnet_cls/data.py:35-44`).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# augmentation (numpy, host-side, applied per batch before device_put)
# ---------------------------------------------------------------------------

def rotate_point_cloud(rng: np.random.Generator, pts: np.ndarray,
                       axis: str = "y") -> np.ndarray:
    """Random rotation about the up axis (`utils/data_util.py:63-74`)."""
    angle = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(angle), np.sin(angle)
    if axis == "y":
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    else:
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    out = pts.copy()
    out[..., :3] = pts[..., :3] @ rot
    return out


def translate_point_cloud(rng: np.random.Generator, pts: np.ndarray,
                          scale_low=2.0 / 3.0, scale_high=3.0 / 2.0,
                          shift_range=0.2) -> np.ndarray:
    """Random anisotropic scale + shift (`examples/modelnet_cls/data.py:35-44`)."""
    scale = rng.uniform(scale_low, scale_high, (3,)).astype(np.float32)
    shift = rng.uniform(-shift_range, shift_range, (3,)).astype(np.float32)
    out = pts.copy()
    out[..., :3] = pts[..., :3] * scale + shift
    return out


def jitter_point_cloud(rng: np.random.Generator, pts: np.ndarray,
                       sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    """Gaussian jitter (`utils/data_util.py:77-87`)."""
    noise = np.clip(sigma * rng.standard_normal(pts[..., :3].shape), -clip,
                    clip).astype(np.float32)
    out = pts.copy()
    out[..., :3] = pts[..., :3] + noise
    return out


# ---------------------------------------------------------------------------
# loaders (h5 gated on availability)
# ---------------------------------------------------------------------------

def _h5py():
    """h5py, imported only by the loaders that read files."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading the point-cloud h5 files needs the h5py package, which "
                          "is not installed; pass --synthetic to run on synthetic data") from e
    return h5py


def _load_h5_pairs(files):
    h5py = _h5py()

    datas, labels = [], []
    for f in files:
        with h5py.File(f, "r") as h:
            datas.append(np.asarray(h["data"]))
            labels.append(np.asarray(h["label"]))
    return np.concatenate(datas, 0), np.concatenate(labels, 0).squeeze()


def load_modelnet40(root: str, split: str = "train", num_points: int = 1024):
    """ModelNet40 ply_hdf5_2048 files (`examples/modelnet_cls/data.py:20-33`)."""
    pat = os.path.join(root, "modelnet40_ply_hdf5_2048", f"ply_data_{split}*.h5")
    files = sorted(glob.glob(pat))
    if not files:
        raise FileNotFoundError(
            f"No ModelNet40 h5 files under {pat}; pass --synthetic (no egress).")
    data, labels = _load_h5_pairs(files)
    return data[:, :num_points, :].astype(np.float32), labels.astype(np.int64)


def load_s3dis(root: str, test_area: int = 5, split: str = "train"):
    """S3DIS indoor3d_sem_seg h5 blocks (4096 pts × 9 feats, 13 classes)."""
    all_files = sorted(glob.glob(os.path.join(root, "indoor3d_sem_seg_hdf5_data",
                                              "ply_data_all_*.h5")))
    room_list = os.path.join(root, "indoor3d_sem_seg_hdf5_data", "room_filelist.txt")
    if not all_files or not os.path.exists(room_list):
        raise FileNotFoundError(
            f"No S3DIS h5 data under {root}; pass --synthetic (no egress).")
    data, labels = _load_h5_pairs(all_files)
    rooms = [l.rstrip() for l in open(room_list)]
    is_test = np.array([f"Area_{test_area}" in r for r in rooms])
    sel = is_test if split == "test" else ~is_test
    return data[sel].astype(np.float32), labels[sel].astype(np.int64)


# ---------------------------------------------------------------------------
# synthetic stand-ins
# ---------------------------------------------------------------------------

def synthetic_modelnet(rng: np.random.Generator, n_samples: int = 256,
                       num_points: int = 1024, num_classes: int = 40):
    """Class-dependent gaussian blobs with per-class anisotropy (learnable)."""
    labels = rng.integers(0, num_classes, n_samples)
    scales = 0.3 + rng.random((num_classes, 3)).astype(np.float32)
    pts = rng.standard_normal((n_samples, num_points, 3)).astype(np.float32)
    pts *= scales[labels][:, None, :]
    return pts, labels.astype(np.int64)


def synthetic_s3dis(rng: np.random.Generator, n_blocks: int = 64,
                    num_points: int = 1024, num_classes: int = 13):
    """Blocks of 9-dim points; label = spatial octant-ish function (learnable)."""
    data = rng.random((n_blocks, num_points, 9)).astype(np.float32)
    xyz = data[..., :3]
    labels = ((xyz[..., 0] > 0.5).astype(np.int64) * 4
              + (xyz[..., 1] > 0.5).astype(np.int64) * 2
              + (xyz[..., 2] > 0.5).astype(np.int64)) % num_classes
    return data, labels


def batch_iter(rng: np.random.Generator, data: np.ndarray, labels: np.ndarray,
               batch_size: int, shuffle: bool = True, augment: bool = False
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    idx = np.arange(len(data))
    if shuffle:
        rng.shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        b = idx[i: i + batch_size]
        x = data[b]
        if augment:
            x = translate_point_cloud(rng, x)
        yield x, labels[b]


# ---------------------------------------------------------------------------
# PartNet sem_seg_h5 (`utils/data_util.py:98-234`, sem_seg_h5 branch)
# ---------------------------------------------------------------------------

def load_partnet(root: str, obj_category: str = "Bed", level: int = 3,
                 phase: str = "train"):
    """PartNet semantic-segmentation h5 → (points [S, N, 3] f32, labels [S, N] i64).

    Mirrors the reference PartNet dataset's sem_seg_h5 branch
    (`utils/data_util.py:216-234`): files live at
    `{root}/sem_seg_h5/{obj_category}-{level}/{phase}-*.h5` with datasets
    'data' [B, N, 3] and 'label_seg' [B, N].  (The reference wraps each object
    into a PyG Data and collates; here objects stay a padded dense array — the
    dense B×N×C layout the models consume directly.)
    """
    obj = f"{obj_category}-{level}"
    pat = os.path.join(root, "sem_seg_h5", obj, f"{phase}-*.h5")
    files = sorted(glob.glob(pat))
    if not files:
        raise FileNotFoundError(
            f"No PartNet h5 files under {pat}; download requires application "
            "(https://cs.stanford.edu/~kaichun/partnet/) — or pass --synthetic.")
    pts, labels = [], []
    h5py = _h5py()
    for f in files:
        with h5py.File(f, "r") as h:
            pts.append(np.asarray(h["data"], np.float32)[..., :3])
            labels.append(np.asarray(h["label_seg"], np.int64))
    return np.concatenate(pts, 0), np.concatenate(labels, 0)


def write_partnet_h5(root: str, obj_category: str, level: int, phase: str,
                     points: np.ndarray, labels: np.ndarray,
                     shapes_per_file: int = 0) -> list:
    """Write PartNet-layout h5 files (the reference's expected on-disk format) —
    used to build test fixtures and to convert foreign caches."""
    h5py = _h5py()
    d = os.path.join(root, "sem_seg_h5", f"{obj_category}-{level}")
    os.makedirs(d, exist_ok=True)
    n = len(points)
    per = shapes_per_file or n
    paths = []
    for i, lo in enumerate(range(0, n, per)):
        path = os.path.join(d, f"{phase}-{i:02d}.h5")
        with h5py.File(path, "w") as h:
            h.create_dataset("data", data=np.asarray(points[lo:lo + per], np.float32))
            h.create_dataset("label_seg", data=np.asarray(labels[lo:lo + per], np.int64))
        paths.append(path)
    return paths


def synthetic_partnet(rng: np.random.Generator, n_shapes: int = 32,
                      num_points: int = 1024, n_classes: int = 10):
    """Angular-sector part labels (learnable from geometry) — PartNet stand-in."""
    pts = rng.standard_normal((n_shapes, num_points, 3)).astype(np.float32)
    ang = np.arctan2(pts[..., 1], pts[..., 0])
    lab = ((ang + np.pi) / (2 * np.pi) * n_classes).astype(np.int64)
    return pts, np.clip(lab, 0, n_classes - 1)
