"""The benchmark finds its parts by name, and takes up new ones from new
files alone; ``BENCHMARK.json`` keeps to its contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from portbench import catalog

BENCH = catalog.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
#: the numbers that ``check.judge`` compares
COMPARED = ("peaks_unmatched_pct", "peaks_moved_pct", "person_score_gap",
            "people_unconverted")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_parts(cell):
    cfg = catalog.load_config(cell["config"])
    traffic = catalog.load_traffic(cell["traffic"])
    limits = catalog.load_limits(cell["name"])
    assert cfg["model"] and cfg["dtype"] in ("bfloat16", "float32")
    assert traffic["batch"] > 0 and traffic["inflight"] > 0
    assert {"peaks_unmatched_pct", "person_score_gap",
            "people_unconverted"} <= set(limits) <= set(COMPARED)
    from portbench.reference import family

    assert callable(family(cfg["reference"]).forward)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_finds_its_reader(metric):
    assert callable(catalog.load_reader(metric["name"]))


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [c["name"] for c in BENCH["configs"]]
    for cfg in BENCH["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        assert json.loads((catalog.REPO / cfg["file"]).read_text())[
            "reduced"] == cfg["reduced"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["config"] in names and cell["chips"] == 1
        assert len(cell["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    every = [x["name"] for x in (BENCH["configs"] + BENCH["workloads"]
                                 + BENCH["end_to_end"] + BENCH["per_layer"])]
    assert all(NAME.match(n) for n in every)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_files_are_taken_up(tiny, run_tiny):
    """A configuration, a traffic mix, limits and a metric added as files
    of their own run as a new cell, with no other file edited."""
    root, bench = tiny
    cfg = catalog.load_config("mobilenet_thin", root)
    cfg["model"] = "mobilenet_thin"
    (root / "configs" / "thin_copy.json").write_text(json.dumps(cfg))
    traffic = catalog.load_traffic("mt-crowd", root)
    traffic["batch"] = 3
    (root / "traffic" / "crowd-b3.json").write_text(json.dumps(traffic))
    (root / "limits" / "thin_copy-crowd-b3.json").write_text(
        (root / "limits" / "mt-crowd.json").read_text())
    (root / "metrics" / "frames_seen.stream.py").write_text(
        "def read(run):\n    return float(run['frames'])\n")
    bench["workloads"].append({"name": "thin_copy-crowd-b3",
                               "config": "thin_copy", "traffic": "crowd-b3",
                               "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({
        "name": "frames_seen.stream", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "frames_per_s"})
    try:
        result = run_tiny("thin_copy-crowd-b3", 5, trace=True)
    finally:
        bench["workloads"].pop()
        bench["per_layer"].pop()
    assert result["correct"], result["checks"]
    assert result["metrics"]["frames_seen.stream"]["value"] > 0
    assert result["metrics"]["frames_seen.stream"]["value"] % 3 == 0
    # device readings need a card: their readers return nothing here
    assert "idle_pct.stream" not in result["metrics"]
