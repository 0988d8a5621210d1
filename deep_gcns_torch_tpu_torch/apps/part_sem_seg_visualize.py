"""Prediction against ground truth across result folders, headless
(counterpart of `examples/part_sem_seg/visualize.py`): the reference opens a
VTK window; this writes one coloured PLY with the clouds side by side along
x, the ground truth first, then each folder's prediction, read from
`part_sem_seg_eval`'s `{category}_{i}_{pred,gt}.obj` files:

    result/
    ├── plain/Bed/Bed_0_pred.obj ...
    └── res/Bed/Bed_0_pred.obj ...

    python -m deep_gcns_torch_tpu_torch.apps.part_sem_seg_visualize --dir_path result \\
        --folders plain,res --category 4 --obj_no 0 --out compare.ply

With ``--exp_dir`` the comparison is also logged as a mesh summary
(`ScalarLogger.log_mesh`, `{exp_dir}/meshes/compare_{obj_no}.ply`).
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from ..utils.logger import ScalarLogger
from ..utils.pc_export import write_ply

# `visualize.py:11-13`'s category table
CATEGORY_NAMES = [
    "Bag", "Bed", "Bottle", "Bowl", "Chair", "Clock", "Dishwasher", "Display", "Door",
    "Earphone", "Faucet", "Hat", "Keyboard", "Knife", "Lamp", "Laptop", "Microwave", "Mug",
    "Refrigerator", "Scissors", "StorageFurniture", "Table", "TrashCan", "Vase"]


def read_colored_obj(path: str):
    """'v x y z r g b' lines → (points [P, 3] f32, colours [P, 3] u8)."""
    pts, cols = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if len(t) >= 7 and t[0] == "v":
                pts.append([float(t[1]), float(t[2]), float(t[3])])
                cols.append([int(float(t[4])), int(float(t[5])), int(float(t[6]))])
    return np.asarray(pts, np.float32), np.asarray(cols, np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Returns the path of the comparison PLY."""
    ap = argparse.ArgumentParser(description="PartNet predictions side by side")
    ap.add_argument("--category", type=int, default=4)
    ap.add_argument("--obj_no", type=int, default=0)
    ap.add_argument("--dir_path", type=str, default="../result")
    ap.add_argument("--folders", type=str, default="plain,res",
                    help='"," separated result folders, e.g. "res,plain"')
    ap.add_argument("--out", type=str, default="compare.ply")
    ap.add_argument("--spacing", type=float, default=2.5,
                    help="x offset between side-by-side clouds")
    ap.add_argument("--exp_dir", type=str, default="",
                    help="also log the comparison as a mesh summary there")
    args = ap.parse_args(argv)
    category = CATEGORY_NAMES[args.category]
    folders = [f.strip() for f in args.folders.split(",")]
    panels = [("ground_truth", osp.join(args.dir_path, folders[0], category,
                                        f"{category}_{args.obj_no}_gt.obj"))]
    panels += [(f, osp.join(args.dir_path, f, category, f"{category}_{args.obj_no}_pred.obj"))
               for f in folders]
    all_pts, all_cols = [], []
    for i, (name, path) in enumerate(panels):
        if not osp.exists(path):
            raise FileNotFoundError(f"missing {path}: run part_sem_seg_eval first")
        pts, cols = read_colored_obj(path)
        pts[:, 0] += i * args.spacing
        all_pts.append(pts)
        all_cols.append(cols)
        print(f"panel {i}: {name} ({len(pts)} pts)", flush=True)
    pts, cols = np.concatenate(all_pts), np.concatenate(all_cols)
    out = write_ply(args.out, pts, colors=cols)
    if args.exp_dir:
        ScalarLogger(args.exp_dir).log_mesh(args.obj_no, "compare", pts, colors=cols)
    print(f"wrote side-by-side comparison to {out} (panels: ground truth, "
          f"{', '.join(folders)})", flush=True)
    return out


if __name__ == "__main__":
    main()
