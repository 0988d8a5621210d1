"""The port stands alone: it imports neither jax nor the JAX package."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deep_gcns_torch_tpu_torch")
MODULES = ["deep_gcns_torch_tpu_torch", "deep_gcns_torch_tpu_torch.device",
           "deep_gcns_torch_tpu_torch.graph", "deep_gcns_torch_tpu_torch.ops._build",
           "deep_gcns_torch_tpu_torch.data.synthetic", "deep_gcns_torch_tpu_torch.nn.core",
           "deep_gcns_torch_tpu_torch.native", "deep_gcns_torch_tpu_torch.data.reorder",
           "deep_gcns_torch_tpu_torch.ops.segment", "deep_gcns_torch_tpu_torch.ops.spmm_cuda",
           "deep_gcns_torch_tpu_torch.ops.band", "deep_gcns_torch_tpu_torch.ops.gat_dense",
           "deep_gcns_torch_tpu_torch.convs.sparse",
           "deep_gcns_torch_tpu_torch.models.deeper_gcn",
           "deep_gcns_torch_tpu_torch.utils.loss", "deep_gcns_torch_tpu_torch.utils.optim",
           "deep_gcns_torch_tpu_torch.utils.metrics",
           "deep_gcns_torch_tpu_torch.utils.import_jax",
           "deep_gcns_torch_tpu_torch.apps.ogbn_arxiv",
           "deep_gcns_torch_tpu_torch.data.partition", "deep_gcns_torch_tpu_torch.data.ogb",
           "deep_gcns_torch_tpu_torch.rev", "deep_gcns_torch_tpu_torch.rev.coupling",
           "deep_gcns_torch_tpu_torch.rev.invertible", "deep_gcns_torch_tpu_torch.rev.rev_layer",
           "deep_gcns_torch_tpu_torch.models.rev_gcn",
           "deep_gcns_torch_tpu_torch.apps.proteins_common",
           "deep_gcns_torch_tpu_torch.apps.ogbn_proteins",
           "deep_gcns_torch_tpu_torch.apps.ogbn_proteins_rev",
           "deep_gcns_torch_tpu_torch.ops.gather", "deep_gcns_torch_tpu_torch.convs",
           "deep_gcns_torch_tpu_torch.convs.dgl_gat", "deep_gcns_torch_tpu_torch.models",
           "deep_gcns_torch_tpu_torch.models.rev_gat",
           "deep_gcns_torch_tpu_torch.apps.ogbn_arxiv_dgl",
           "deep_gcns_torch_tpu_torch.ops.blocksparse", "deep_gcns_torch_tpu_torch.utils.ckpt",
           "deep_gcns_torch_tpu_torch.utils.ckpt_async",
           "deep_gcns_torch_tpu_torch.utils.import_torch",
           "deep_gcns_torch_tpu_torch.utils.logger", "deep_gcns_torch_tpu_torch.utils.profiling",
           "deep_gcns_torch_tpu_torch.apps.ogbn_arxiv_test",
           "deep_gcns_torch_tpu_torch.apps.ogbn_proteins_test",
           "deep_gcns_torch_tpu_torch.data.ogb_features",
           "deep_gcns_torch_tpu_torch.models.link_predictor",
           "deep_gcns_torch_tpu_torch.apps.common", "deep_gcns_torch_tpu_torch.apps.ogbg_mol",
           "deep_gcns_torch_tpu_torch.apps.ogbg_mol_test",
           "deep_gcns_torch_tpu_torch.apps.ogbg_ppa",
           "deep_gcns_torch_tpu_torch.apps.ogbg_ppa_test",
           "deep_gcns_torch_tpu_torch.apps.ogbl_collab",
           "deep_gcns_torch_tpu_torch.apps.ogbl_collab_test",
           "deep_gcns_torch_tpu_torch.apps.ogbn_products",
           "deep_gcns_torch_tpu_torch.apps.ogbn_products_test"]


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
            "or k == 'deep_gcns_torch_tpu' or k.startswith('deep_gcns_torch_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("needle", ["import jax", "from jax", "deep_gcns_torch_tpu.",
                                    "from deep_gcns_torch_tpu import"])
def test_no_source_names_jax(needle):
    hits = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            if needle in f.read():
                hits.append(os.path.relpath(path, ROOT))
    assert not hits, f"{needle!r} in {hits}"
