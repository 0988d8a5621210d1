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
    positive time for K2, K2 with `ee` at C=40 and 64, and K10, each in
    float32 and bfloat16, and prints no device result."""
    import json
    import subprocess
    import sys

    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rehearse-cpu",
                          "--kernel-times"], capture_output=True, text=True, timeout=300,
                         check=True)
    last = json.loads(run.stdout.strip().splitlines()[-1])
    want = {f"{k} {d}" for k in ("K2 C=128", "K2 ee C=40", "K2 ee C=64", "K10 C=128")
            for d in ("f32", "bf16")}
    assert set(last["kernel_ms"]) == want
    assert all(v > 0 for v in last["kernel_ms"].values())
    assert '"ok"' not in run.stdout
