"""Every name in BENCHMARK.json resolves to its file, and the harness finds a
new configuration, traffic mix, metric or kernel cost by its name alone."""

import json
import os
import shutil

import pytest

from h100bench import harness

B = harness.benchmark()


def test_contract_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert all(os.path.isdir(os.path.join(harness.ROOT, p)) for p in B["paths"])
    assert {m["name"] for m in B["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cell = harness.resolve_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert set(cell.limits) == {"loss", "grad", "change", "eval"}
    for m in cell.per_layer + cell.end_to_end:
        assert os.path.exists(os.path.join(harness.HERE, "metrics", f"{m['name']}.py"))
    assert cell.per_layer and len(cell.end_to_end) >= 2


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_every_config_has_its_files(c):
    for sub in (f"configs/{c['name']}.json", f"configs/{c['name']}.py",
                f"reference/{c['name']}.py"):
        assert os.path.exists(os.path.join(harness.HERE, sub)), sub
    cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
    assert cfg["reduced"] == c["reduced"]


def test_every_roofline_metric_has_a_cost():
    for m in B["per_layer"]:
        if m["name"].endswith("_roofline"):
            k = m["name"][:-len("_roofline")]
            mod = harness.load_module(os.path.join(harness.HERE, "costs", f"{k}.py"))
            assert mod.NAME.startswith("dgc::") and callable(mod.cost)


def test_a_new_cell_is_found_by_name(tmp_path):
    """A copy of the benchmark with one more configuration, traffic mix,
    cell, metric and kernel cost, added as files alone, resolves without an
    edit to any file it had."""
    root = tmp_path / "co"
    shutil.copytree(harness.HERE, root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(B))
    tr = json.load(open(os.path.join(harness.HERE, "traffic", "arxiv-powerlaw.json")))
    json.dump(dict(tr, reorder="cluster", band="auto"),
              open(root / "h100bench" / "traffic" / "arxiv-powerlaw-band.json", "w"))
    (root / "h100bench" / "metrics" / "host.extra_s.py").write_text(
        "def read(ctx):\n    return ctx.host_build_s\n")
    here = root / "h100bench"
    for sub, ext in (("configs", "json"), ("configs", "py"), ("reference", "py")):
        shutil.copy(here / sub / f"revgat5-arxiv.{ext}", here / sub / f"revgat7-arxiv.{ext}")
    (here / "costs" / "K3.py").write_text(
        'NAME = "dgc::band"\n\n\ndef cost(s):\n    return 0.0, 1.0\n')
    bench["configs"].append({"name": "revgat7-arxiv", "source": "x", "reduced": [],
                             "file": "h100bench/configs/revgat7-arxiv.json", "why": "x"})
    bench["workloads"].append({"name": "revgat5-arxiv-band", "config": "revgat7-arxiv",
                               "traffic": "arxiv-powerlaw-band", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "host.extra_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "host build",
                               "moves": "setup_s", "workloads": ["revgat5-arxiv-band"]})
    cell = harness.resolve_cell("revgat5-arxiv-band", root=str(root), bench=bench)
    assert cell.traffic["band"] == "auto"
    assert cell.config_mod.__file__.endswith("revgat7-arxiv.py")
    assert cell.reference.__file__.endswith("revgat7-arxiv.py")
    assert harness.load_module(str(here / "costs" / "K3.py")).cost({}) == (0.0, 1.0)
    assert [m["name"] for m in cell.per_layer] == ["host.extra_s"]
    assert cell.limits == {}  # a new cell brings its own cells/<name>.json
