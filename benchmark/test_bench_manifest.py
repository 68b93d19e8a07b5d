"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name. CPU only.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import run

MANIFEST = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (run.ROOT / p).is_dir()


def test_run_seconds_fit_the_full_check():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("table", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique_and_well_formed(table):
    names = [e["name"] for e in MANIFEST[table]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_tables():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in MANIFEST["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert line_ok(metric["layer"])
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for w in metric.get("workloads", []):
        assert w in CELLS


def test_setup_s_is_an_end_to_end_metric():
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25
    assert "workloads" not in setup[0]


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_what_its_cells_report(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    moved = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert w in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = run.cell_metrics(MANIFEST, cell, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert run.cell_metrics(MANIFEST, cell, "per_layer")


def test_configs_and_cells():
    cfgs = {c["name"] for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == cfgs
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line_ok(w["why"]) and NAME.match(w["traffic"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_is_found_by_name(cell):
    files = run.cell_files(cell, MANIFEST)
    cfg, traffic = files["config"], files["traffic"]
    entry = {c["name"]: c for c in MANIFEST["configs"]}[
        files["cell"]["config"]]
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert traffic["name"] == files["cell"]["traffic"]
    assert (run.BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    for m in run.cell_metrics(MANIFEST, cell, "end_to_end"):
        assert m["name"] == "setup_s" or m["name"] in traffic["end_to_end"]
    for m in run.cell_metrics(MANIFEST, cell, "per_layer"):
        assert callable(run.reader(m["name"]))
    assert files["limits"]


def test_no_stray_files():
    """Every configuration, traffic mix, cell and metric file belongs to an
    entry of BENCHMARK.json."""
    bench = run.BENCH
    cfg_files = {Path(c["file"]).name for c in MANIFEST["configs"]}
    assert {p.name for p in (bench / "configs").glob("*.json")} == cfg_files
    traffic = {w["traffic"] for w in MANIFEST["workloads"]}
    assert {p.stem for p in (bench / "traffic").glob("*.json")} == traffic
    assert {p.stem for p in (bench / "cells").glob("*.json")} == set(CELLS)
    readers = {m["name"] for m in MANIFEST["per_layer"]}
    assert {p.name[:-3] for p in (bench / "metrics").glob("*.py")} == readers
