"""Cells, configurations, traffic mixes, metrics and kernel maps are found
by their names in BENCHMARK.json."""

from __future__ import annotations

import importlib
import json
import re

from portbench import run

from .tiny import PKG

ROOT = PKG.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads():
    for w in BENCH["workloads"]:
        bench, cell, cfg, traffic, check = run.load_cell(ROOT, w["name"])
        assert cell is not None and cfg["system"]
        importlib.import_module(f"portbench.traffic.{traffic['kind']}")
        importlib.import_module(f"portbench.systems.{cfg['system']}")
        assert set(check["limits"])
        for trace in (False, True):
            ms = run.cell_metrics(bench, w["name"], trace)
            assert ms, (w["name"], trace)
        assert any(m["name"] == "setup_s" for m in run.cell_metrics(bench, w["name"], False))


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


def test_every_kernel_map_a_reader_names_exists():
    named = set()
    for f in (PKG / "metrics").glob("*.py"):
        named |= set(re.findall(r'layer_s\("([a-z0-9_]+)"\)', f.read_text()))
    assert named
    for layer in named:
        pats = json.loads((PKG / "kernels" / f"{layer}.json").read_text())["patterns"]
        assert pats and all(re.compile(p) for p in pats)


def test_per_layer_metrics_name_their_cells_and_layers():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
