"""No run loads JAX, flax or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and the references
import none of the three packages."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN_RUN = {"jax", "jaxlib", "flax", "deep_gcns_torch_tpu"}
FORBIDDEN_REF = {"jax", "deep_gcns_torch_tpu", "deep_gcns_torch_tpu_torch"}

RUN_TINY = r"""
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
from h100bench import run
from conftest import cells, tiny_cell
for name in cells():
    run.drive(tiny_cell(name), 5, 0.0, True, torch.device("cpu"), 0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    """A whole run of each cell at a tiny size on the CPU, traced, reference
    included, in a fresh process: every module it loaded is checked."""
    code = RUN_TINY.format(root=ROOT, tests=os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "deep_gcns_torch_tpu_torch" in loaded and "h100bench" in loaded
    assert not loaded & FORBIDDEN_RUN, loaded & FORBIDDEN_RUN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_the_references_import_none_of_the_packages():
    files = glob.glob(os.path.join(ROOT, "h100bench", "reference", "*.py"))
    assert len(files) >= 2
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN_REF, f
    code = ("import sys, glob, json; sys.path.insert(0, {root!r})\n"
            "from h100bench import harness\n"
            "for f in glob.glob({pat!r}): harness.load_module(f)\n"
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))").format(
        root=ROOT, pat=os.path.join(ROOT, "h100bench", "reference", "*.py"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert not set(json.loads(p.stdout.strip().splitlines()[-1])) & FORBIDDEN_REF
