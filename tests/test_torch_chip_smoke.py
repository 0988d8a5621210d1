"""chip_smoke.py's failure capture: a failed comparison saves the tensors it
compared, and the inputs it was given, so that a miss of the CPU rehearsal
or of the card can be replayed."""

import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the script imports torch where it runs as a program, after its checks
    monkeypatch.setattr(mod, "torch", torch, raising=False)
    monkeypatch.setattr(mod, "FAIL_DIR", str(tmp_path / "check_failures"))
    return mod


def test_failed_close_saves_what_it_compared(monkeypatch, tmp_path):
    mod = _chip_smoke(monkeypatch, tmp_path)
    chk = mod.Checks("kernels")
    want = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = want.clone()
    got[1, 2] += 1e-3  # a forced miss of TOL_F32
    x = torch.randn(4, 3)
    err = chk.close("K2 out f32", got, want, inputs={"x": x, "eps": 1e-7}, **mod.TOL_F32)
    assert chk.failed == ["K2 out f32"] and abs(err - 1e-3) < 1e-6
    path = tmp_path / "check_failures" / "kernels-K2_out_f32.pt"
    saved = torch.load(path, weights_only=False)
    assert torch.equal(saved["got"], got) and torch.equal(saved["want"], want)
    assert torch.equal(saved["inputs"]["x"], x) and saved["inputs"]["eps"] == 1e-7
    assert saved["limits"]["rtol"] == mod.TOL_F32["rtol"] and saved["phase"] == "kernels"
    # a passing check writes nothing
    chk.close("K2 den f32", want, want, **mod.TOL_F32)
    assert os.listdir(tmp_path / "check_failures") == ["kernels-K2_out_f32.pt"]


def test_kernel_times_mode_prints_one_time_per_kernel_form():
    """`--kernel-times` (rehearsed on the CPU) ends in one JSON line with a
    positive time for K2, K2 with `ee` at C=40 and 64, K4 without dt at C=40
    and with dt at C=64, and K10, each in float32 and bfloat16, K7, K8 and K9
    at 3x128 (float32 and bfloat16), 3x256 and 1x40 (bfloat16), and K5 and
    K6 at P=392 (float32 and bfloat16), 776 and 48 (bfloat16), and K1 at
    every shape of `K1_PATHS` (gathered at C=128 in float32 and bfloat16,
    plain at C=128, the dense RevGAT leftover's 392, 776, 48 and 8, the
    band leftover's gathered 128 and 256), K1's also as device times; with
    `--output-hashes` a digest of each K1, K5, K6 (dmsg and d_el apart),
    K7, K8 and K9 output; and prints no device result."""
    import json
    import subprocess
    import sys

    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rehearse-cpu",
                          "--kernel-times", "--output-hashes"], capture_output=True,
                         text=True, timeout=300, check=True)
    last = json.loads(run.stdout.strip().splitlines()[-1])
    want = {f"{k} {d}" for k in ("K2 C=128", "K2 ee C=40", "K2 ee C=64", "K4 C=40",
                                 "K4 dt C=64", "K10 C=128") for d in ("f32", "bf16")}
    dense = {"3x128 bf16", "3x256 bf16", "1x40 bf16", "3x128 f32"}
    want |= {f"{k} {s}" for k in ("K7", "K8", "K9") for s in dense}
    csc = ("P=392 bf16", "P=776 bf16", "P=48 bf16", "P=392 f32")
    k5 = {f"K5 {s}" for s in csc}
    k1 = {f"K1 {s}" for s in ("gather C=128 bf16", "gather C=128 f32", "plain C=128 bf16",
                              "lo C=392 bf16", "lo C=776 bf16", "lo C=48 bf16", "lo C=8 f32",
                              "band-lo C=128 bf16", "band-lo C=256 bf16")}
    assert set(last["kernel_ms"]) == want | k5 | {f"K6 {s}" for s in csc} | k1
    assert all(v > 0 for v in last["kernel_ms"].values())
    assert set(last["kernel_device_ms"]) == k1
    assert all(v > 0 for v in last["kernel_device_ms"].values())
    assert set(last["outputs_sha256"]) == k5 | {f"K7 {s}" for s in dense} | {
        f"K9 {o} {s}" for o in ("d_el", "d_feat") for s in dense} | {
        f"K8 d_er {s}" for s in dense} | {
        f"K6 {o} {s}" for o in ("dmsg", "d_el") for s in csc} | k1
    assert '"ok"' not in run.stdout


def test_kernel_forms_argument(monkeypatch, tmp_path):
    """`--kernel-forms` names the kernels whose forms are built and timed:
    all of `KERNEL_FORMS` when none is named, `--k7-forms` K7 alone; every
    constant a form replaces stands once as a `constexpr int` in the
    kernel's source, and every wrapper attribute it sets exists."""
    import re

    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd
    from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp

    mod = _chip_smoke(monkeypatch, tmp_path)
    assert mod.kernel_forms_arg(["--kernel-forms"]) == ["K7", "K9", "K5", "K8", "K6", "K1"]
    assert mod.kernel_forms_arg(["--kernel-forms=K1"]) == ["K1"]
    assert mod.kernel_forms_arg(["--kernel-forms=K9,K5"]) == ["K9", "K5"]
    assert mod.kernel_forms_arg(["--kernel-forms=K8,K6"]) == ["K8", "K6"]
    assert mod.kernel_forms_arg(["--k7-forms"]) == ["K7"]
    assert mod.kernel_forms_arg(["--kernel-times"]) == []
    for kernel, (src, forms) in mod.KERNEL_FORMS.items():
        text = open(os.path.join(ROOT, "deep_gcns_torch_tpu_torch", "csrc", f"{src}.cu")).read()
        module = tsp if kernel in ("K5", "K6", "K1") else tgd
        assert forms[0][1:] == ({}, {})
        for _, consts, attrs in forms:
            for k in consts:
                assert len(re.findall(rf"constexpr int {k} = \d+;", text)) == 1, (kernel, k)
            assert all(hasattr(module, a) for a in attrs), (kernel, attrs)


def test_ogb_mode_rehearses_the_ogb_phases():
    """`--ogb` (rehearsed on the CPU, tiny) runs phases 40-46: the OGB kernel
    shapes against their plain versions, the small models card against CPU
    (here CPU against CPU), the five app paths with their checkpoint
    reproductions, and ends in one `kernels` line with a complete row for
    each OGB shape; it prints no device result and leaves no run
    directory."""
    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rehearse-cpu",
                          "--ogb"], capture_output=True, text=True, timeout=300, check=True)
    for tag in ("ogb kernels", "ogb agreement", "molhiv-dyresgen-7", "molpcba-resgen-14-vn",
                "ppa-resgen-28", "ogbl-collab", "ogbn-products", "ogb timing"):
        assert f"[time] {tag} done" in run.stdout, tag
    for tag in ("molhiv-dyresgen-7-ckpt", "molpcba-resgen-14-vn-ckpt", "ppa-resgen-28-ckpt",
                "ogbl-collab-ckpt", "ogbn-products-ckpt"):
        assert f"[{tag}]" in run.stdout, tag
    rows = json.loads(run.stdout.strip().splitlines()[-1])["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert [r["name"].split(" (")[0] for r in rows] == [s[0] for s in _ogb_shapes()]
    assert all(set(r) == keys and r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    assert '"ok"' not in run.stdout
    assert not os.path.exists(os.path.join(ROOT, "chiprun_out", "smoke_runs"))


def _ogb_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.OGB_SHAPES
