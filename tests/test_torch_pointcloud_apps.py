"""The port's point-cloud data and apps on the CPU: the synthetic sets,
augmentation and batching against the JAX package's draw for draw (also in
each JAX app's order of draws), the h5 loaders, the PLY export and
`log_mesh`, and each app with its test or eval script, whose score must
equal the run's best exactly.
"""

import argparse
import importlib.util
import os
import sys

import numpy as np
import pytest

from deep_gcns_torch_tpu.data import pointcloud as jpc
from deep_gcns_torch_tpu.utils import pc_export as jexport
from deep_gcns_torch_tpu_torch.apps import (modelnet_cls, part_sem_seg, part_sem_seg_eval,
                                            part_sem_seg_visualize, sem_seg_dense,
                                            sem_seg_dense_test, sem_seg_sparse,
                                            sem_seg_sparse_test)
from deep_gcns_torch_tpu_torch.data import pointcloud as tpc
from deep_gcns_torch_tpu_torch.utils import pc_export as texport
from deep_gcns_torch_tpu_torch.utils.logger import ScalarLogger
from torch_budget import budget  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_app(name, script):
    path = os.path.join(REPO, "examples", name, script)
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.dirname(path))
    return mod


def test_pointcloud_data_matches_jax():
    """The synthetic sets, the augmentations and `batch_iter`, bit for bit
    from one seed."""
    for fn, args in (("synthetic_s3dis", (5, 64, 13)), ("synthetic_modelnet", (6, 32, 40)),
                     ("synthetic_partnet", (4, 50, 10))):
        want = getattr(jpc, fn)(np.random.default_rng(1), *args)
        got = getattr(tpc, fn)(np.random.default_rng(1), *args)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=fn)
    pts = np.random.default_rng(2).standard_normal((3, 20, 6)).astype(np.float32)
    for fn in ("rotate_point_cloud", "translate_point_cloud", "jitter_point_cloud"):
        np.testing.assert_array_equal(getattr(tpc, fn)(np.random.default_rng(3), pts),
                                      getattr(jpc, fn)(np.random.default_rng(3), pts),
                                      err_msg=fn)
    np.testing.assert_array_equal(tpc.rotate_point_cloud(np.random.default_rng(3), pts, "z"),
                                  jpc.rotate_point_cloud(np.random.default_rng(3), pts, "z"))
    labels = np.arange(7)
    for aug in (False, True):
        got = list(tpc.batch_iter(np.random.default_rng(4), pts.repeat(3, 0)[:7], labels, 2,
                                  augment=aug))
        want = list(jpc.batch_iter(np.random.default_rng(4), pts.repeat(3, 0)[:7], labels, 2,
                                   augment=aug))
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_apps_draw_the_jax_apps_data():
    """Each app's synthetic splits equal the JAX app's, in the JAX app's
    order of draws."""
    ns = argparse.Namespace(synthetic=True, num_points=64, n_classes=13, data_dir="")
    for name, port, draw in (("sem_seg_dense", sem_seg_dense, "load_split"),
                             ("sem_seg_sparse", sem_seg_sparse, "load_split"),
                             ("modelnet_cls", modelnet_cls, "load_split"),
                             ("part_sem_seg", part_sem_seg, "load_phase")):
        jmod = _jax_app(name, "main.py" if name in ("modelnet_cls", "part_sem_seg")
                        else "train.py")
        splits = ("train", "val") if name == "part_sem_seg" else ("train", "test")
        ns.n_classes = {"modelnet_cls": 40, "part_sem_seg": 10}.get(name, 13)
        rj, rt = np.random.default_rng(5), np.random.default_rng(5)
        for split in splits:
            want = getattr(jmod, draw)(ns, rj, split)
            got = getattr(port, draw)(ns, rt, split)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {split}")


def test_h5_loaders(tmp_path, monkeypatch):
    """PartNet's h5 layout round trip, read by both packages; a missing set
    points at --synthetic; without h5py the loaders say so."""
    pts = np.random.default_rng(6).standard_normal((5, 30, 3)).astype(np.float32)
    lab = np.random.default_rng(7).integers(0, 4, (5, 30))
    tpc.write_partnet_h5(str(tmp_path), "Bed", 3, "train", pts, lab, shapes_per_file=2)
    got = tpc.load_partnet(str(tmp_path), "Bed", 3, "train")
    want = jpc.load_partnet(str(tmp_path), "Bed", 3, "train")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], pts)
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        tpc.load_modelnet40(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        tpc.load_s3dis(str(tmp_path))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tpc.load_partnet(str(tmp_path), "Bed", 3, "train")


def test_ply_export_and_log_mesh(tmp_path):
    pts = np.random.default_rng(8).standard_normal((12, 3)).astype(np.float32)
    lab = np.arange(12) % 5
    for a, b in ((texport.write_ply(str(tmp_path / "t.ply"), pts, labels=lab),
                  jexport.write_ply(str(tmp_path / "j.ply"), pts, labels=lab)),
                 (texport.write_ply(str(tmp_path / "t2.ply"), pts),
                  jexport.write_ply(str(tmp_path / "j2.ply"), pts))):
        assert open(a).read() == open(b).read()
    got = texport.export_part_seg_comparison(str(tmp_path / "t3"), pts, lab, lab[::-1])
    want = jexport.export_part_seg_comparison(str(tmp_path / "j3"), pts, lab, lab[::-1])
    for a, b in zip(got, want):
        assert open(a).read() == open(b).read()
    path = ScalarLogger(str(tmp_path)).log_mesh(3, "cloud", pts, labels=lab)
    assert path == os.path.join(str(tmp_path), "meshes", "cloud_3.ply")
    assert open(path).read() == open(tmp_path / "t.ply").read()


SMALL = ["--synthetic", "--device", "cpu", "--n_blocks", "3", "--n_filters", "16",
         "--num_points", "64", "--k", "4"]


@pytest.mark.parametrize("app,test_app", [(sem_seg_dense, sem_seg_dense_test),
                                          (sem_seg_sparse, sem_seg_sparse_test)])
def test_sem_seg_app_and_test_script(tmp_path, app, test_app):
    """Two epochs with `--save_ckpt`; the test script's mIoU on `ckpt_best`
    equals the run's best, and it gives the area protocol's too."""
    argv = SMALL + ["--exp_root", str(tmp_path)]
    res = app.main(argv + ["--epochs", "2", "--save_ckpt"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["best"] == max(res["miou"])
    scored = test_app.main(argv + ["--pretrained_model", os.path.join(res["exp"], "ckpt_best")])
    assert scored["miou"] == res["best"]
    assert scored["meta"]["epoch"] == res["miou"].index(res["best"])
    assert 0.0 <= scored["area_miou"] <= 1.0 and len(scored["ious"]) == 13


def test_modelnet_app_and_test_phase(tmp_path):
    argv = SMALL + ["--exp_root", str(tmp_path), "--emb_dims", "32", "--batch_size", "16"]
    res = modelnet_cls.main(argv + ["--epochs", "2", "--save_ckpt"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    scored = modelnet_cls.main(argv + ["--phase", "test", "--pretrained_model",
                                       os.path.join(res["exp"], "ckpt_best")])
    assert scored["oa"] == res["best"] == max(res["oa"])
    assert scored["balanced"] == res["balanced"][res["oa"].index(res["best"])]


def test_part_seg_app_eval_and_visualize(tmp_path):
    argv = SMALL + ["--exp_root", str(tmp_path)]
    res = part_sem_seg.main(argv + ["--epochs", "2", "--save_ckpt"])
    assert res["best"] == max(res["part_iou"])
    assert os.path.exists(os.path.join(res["exp"], "ckpt_last.pth"))
    out_dir = tmp_path / "result" / "res" / "Bed"
    scored = part_sem_seg_eval.main(argv + ["--eval_phase", "val", "--res_dir", str(out_dir),
                                            "--max_export", "2", "--pretrained_model",
                                            os.path.join(res["exp"], "ckpt_best")])
    assert scored["part_iou"] == res["best"]
    assert len(scored["exports"]) == 4
    test = part_sem_seg_eval.main(argv + ["--res_dir", str(out_dir), "--max_export", "1",
                                          "--pretrained_model",
                                          os.path.join(res["exp"], "ckpt_best")])
    assert 0.0 <= test["part_iou"] <= 1.0
    out = part_sem_seg_visualize.main(["--dir_path", str(tmp_path / "result"), "--folders",
                                       "res", "--category", "1", "--obj_no", "0", "--out",
                                       str(tmp_path / "cmp.ply"), "--exp_dir",
                                       str(tmp_path / "viz")])
    text = open(out).read()
    assert "element vertex 128" in text
    assert os.path.exists(tmp_path / "viz" / "meshes" / "compare_0.ply")
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        part_sem_seg.main(["--device", "cpu", "--epochs", "1"])
