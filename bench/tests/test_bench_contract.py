"""BENCHMARK.json against the benchmark's contract, and the files each
name in it points to."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def _cells_reporting(bench, metric):
    m = {e["name"]: e for e in bench["end_to_end"]}[metric]
    return set(m.get("workloads", [w["name"] for w in bench["workloads"]]))


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    for p in bench["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(names) == len(set(names))


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_moves_name_a_metric_each_cell_reports(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in _cells_reporting(bench, m["moves"]), (m, cell)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in bench["per_layer"] if w["name"] in m["workloads"]]
        assert len(e2e) >= 2 and layer, w["name"]


def test_roofline_and_mfu_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("bench/configs/")
        cfg = json.load(open(ROOT / c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    from bench.jobs import KINDS
    for w in bench["workloads"]:
        traffic = json.load(open(ROOT / "bench" / "traffic"
                                 / f"{w['traffic']}.json"))
        assert traffic["kind"] in KINDS
        limits = json.load(open(ROOT / "bench" / "limits"
                                / f"{w['name']}.json"))
        assert limits and all(v >= 0 for v in limits.values())
    for m in bench["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()


def test_chip_time_fits(bench):
    """A full check of 24 cells at this run length fits in 12 hours."""
    per_run = bench["run_seconds"] + 60
    assert 1200 + 24 * 2 * 90 + (2 + 14 * 24) * per_run <= 43200
