"""The per-span reduction of the traced run (``bench/spans.py``) on
plain event tuples, its readers, and the SMOKE traced run on the CPU
with the program's spans and counters read."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import spans  # noqa: E402
from bench.run import read_metric  # noqa: E402
from bench.smoke import smoke_spec  # noqa: E402

UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
NEW = [(kind, name) for kind, names in spans.PROGRAM_METRICS.items()
       for name in names]

# a window 0-100 ns; search.index 10-60 holding search.prune 20-40;
# search.encode 70-90
WINDOW = (0, 100)
SPANS = [(10, 60, "search.index"), (20, 40, "search.prune"),
         (70, 90, "search.encode")]
CALLS = {1: 12, 2: 25, 3: 45, 4: 75, 5: 95, 6: 30, 7: 31}
DEVICE = [(14, 22, 1, "plaid_probe_kernel"),     # launched in index
          (26, 34, 2, "sort_kernel"),            # in prune
          (46, 50, 3, "Memcpy DtoH"),            # a copy, in index
          (76, 80, 4, "gemm"),                   # in encode
          (96, 104, 5, "late_kernel"),           # outside, cut at 100
          (33, 36, 6, "sort_kernel2"),           # overlaps 26-34
          (38, 38, 7, "tiny_kernel")]            # 0 ns, in prune


def _table():
    return spans.span_table(WINDOW, SPANS, CALLS, DEVICE)


def test_device_time_goes_to_the_innermost_span_by_correlation():
    t = _table()
    ns = 1e-9
    assert t["search.index"]["device_s"] == pytest.approx(12 * ns)
    assert t["search.index"]["launches"] == 1       # the copy not counted
    assert t["search.prune"]["device_s"] == pytest.approx(11 * ns)
    assert t["search.prune"]["launches"] == 3       # the 0 ns kernel too
    assert t["search.encode"]["device_s"] == pytest.approx(4 * ns)
    assert t["outside"]["device_s"] == pytest.approx(4 * ns)
    assert (t["search.index"]["count"], t["search.prune"]["count"]) == (1, 1)
    assert t["search.index"]["host_s"] == pytest.approx(50 * ns)


def test_idle_split_adds_up_to_the_window_idle_once():
    t = _table()
    ns = 1e-9
    # busy: 14-22, 26-36, 46-50, 76-80, 96-100 -> idle 0-14, 22-26,
    # 36-46, 50-76, 80-96: 70 ns
    idle = {k: v["idle_s"] / ns for k, v in t.items()}
    assert idle["search.index"] == pytest.approx(4 + 6 + 10)  # 10-14,
    # 40-46, 50-60 (22-26 and 36-40 are the prune's)
    assert idle["search.prune"] == pytest.approx(4 + 4)
    assert idle["search.encode"] == pytest.approx(6 + 10)  # 70-76, 80-90
    assert idle["outside"] == pytest.approx(10 + 10 + 6)  # 0-10, 60-70,
    # 90-96
    assert sum(idle.values()) == pytest.approx(70)


def test_random_spans_conserve_idle_and_device_time():
    import numpy as np
    rng = np.random.default_rng(5)
    starts = np.sort(rng.integers(0, 10_000, 40))
    nested = [(int(s), int(s + rng.integers(5, 400)), f"search.s{i % 5}")
              for i, s in enumerate(starts)]
    dev = []
    calls = {}
    for c in range(300):
        s = int(rng.integers(0, 10_000))
        dev.append((s, s + int(rng.integers(1, 60)), c, "k"))
        calls[c] = int(rng.integers(0, 10_000))
    t = spans.span_table((0, 10_000), nested, calls, dev)
    idle = sum(e - s for s, e in spans._idle((0, 10_000), dev))
    assert sum(r["idle_s"] for r in t.values()) == pytest.approx(idle * 1e-9)
    total = sum(min(e, 10_000) - s for s, e, _, _ in dev) * 1e-9
    assert sum(r["device_s"] for r in t.values()) == pytest.approx(total)
    assert sum(r["launches"] for r in t.values()) == 300


@pytest.mark.parametrize("kind,name", NEW)
def test_each_reader_has_a_file_and_reads_nothing_without_the_program(
        kind, name):
    assert UNIT.match(spans.PROGRAM_METRICS[kind][name])
    assert read_metric(name, {}) is None
    assert read_metric(name, {"docs": 10, "busy_s": 1.0,
                              "trace_window_s": 2.0, "spans": {}}) is None


def test_readers_on_a_table():
    t = _table()
    t["search.encode"]["count"] = t["search.index"]["count"] = 2
    ctx = {"program_spans": t, "docs": 500,
           "program_counters": {"search.batches": 2, "search.host_reads": 6,
                                "search.probe_slots": 400,
                                "search.probe_candidates": 100}}
    assert read_metric("query_encode.device_ms_per_batch", ctx) == (
        pytest.approx(1e3 * 4e-9 / 2))
    assert read_metric("candidates.device_ms_per_batch", ctx) == (
        pytest.approx(1e3 * 11e-9 / 2))
    assert read_metric("index_search.idle_ms_per_batch", ctx) == (
        pytest.approx(1e3 * 28e-9 / 2))
    assert read_metric("index_search.host_reads_per_batch", ctx) == 3
    assert read_metric("candidates.valid_share", ctx) == 25
    assert read_metric("build.index_idle_ms_per_kdoc", ctx) == 0


@pytest.mark.parametrize("cell", ["jacolbertv2.search-batch",
                                  "colbertv2.build"])
def test_smoke_traced_run_fills_the_program_readings(cell, tmp_path):
    spec = smoke_spec(cell)
    spec["work_dir"] = str(tmp_path / "work")
    out, ctx = spans.traced_run(spec, 2 ** 31 + 7, 0.2, "cpu")
    json.dumps(out)
    table, counters = ctx["program_spans"], ctx["program_counters"]
    if cell == "colbertv2.build":
        assert {"build.encode", "build.pool", "build.index", "build.kmeans",
                "build.codes", "build.ivf", "build.views",
                "build.save"} <= set(table)
        assert out["metrics"]["build.index_idle_ms_per_kdoc"] is not None
        return
    batches = counters["search.batches"]
    assert batches == table["search.index"]["count"] > 0
    assert table["search.encode"]["count"] == batches
    assert counters["search.host_reads"] == 3 * batches    # device path
    assert 0 < counters["search.probe_candidates"] <= counters[
        "search.probe_slots"]
    m = out["metrics"]
    assert m["index_search.host_reads_per_batch"] == 3
    assert 0 < m["candidates.valid_share"] <= 100
