#!/usr/bin/env python3
"""The program's spans and counters in the traced run.

The program marks its stages with spans (``repro_torch/trace.py`` lists
them: ``search.*`` and ``build.*``), which a ``torch.profiler`` session
records on the clock of the card's activities, and counts its work in a
counting window. ``span_table`` reduces the trace that ``bench/trace.py``'s
``summary`` reads to per-span results, from plain event tuples
(``events`` takes them out of the profiler): each device activity is
matched by correlation id to the runtime call that launched it and
given to the innermost program span around that call. Per span name:

* ``count``: spans of that name in the window;
* ``host_s``: their host seconds, inside the window;
* ``device_s``: device seconds of the activities launched inside;
* ``launches``: kernels launched inside (copies and sets not counted);
* ``idle_s``: the window's idle time (no activity on the card) that
  falls inside, each piece given to the innermost span over it.

``outside`` holds what no span covers: ``device_s`` and ``launches`` of
activities launched outside every span, and the idle time outside them.
The idle times of all rows sum to the window's idle time. The program's
spans run on one thread in the cells (nesting is by time alone).

Run as a script, it runs one cell as ``bench/run.py --trace 1`` does,
with the program's counting window open, and prints one JSON line: the
cell's per-layer metrics, those read from the program's spans and
counters (``PROGRAM_METRICS``; ``ctx["program_spans"]`` and
``ctx["program_counters"]``), the table and the counters; with
``--cost 1``, first the end-to-end metric of the same set-up measured
plain, inside a counting window and under the profiler (the cost of
tracing), and the host cost of one span with the profiler on and off:

    python3 bench/spans.py --workload jacolbertv2.search-batch \\
        --seed 7 --seconds 50 --cost 1
"""
from __future__ import annotations

import argparse
import heapq
import json
import sys
import time
from bisect import bisect_right
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIXES = ("search.", "build.")
COPIES = ("Memcpy", "Memset")

CANDIDATES = ("search.centroid_scores", "search.probe_members",
              "search.code_gather", "search.plaid_probe", "search.prune")
RERANK = ("search.packed_gather", "search.maxsim_packed",
          "search.maxsim_rerank")
INDEX_SEARCH = ("search.index",) + CANDIDATES + RERANK + ("search.topk",)
BUILD_INDEX = ("build.index", "build.kmeans", "build.codec", "build.codes",
               "build.ivf", "build.views")

# the per-layer metrics read from the program's spans and counters, by
# traffic kind, with their units
PROGRAM_METRICS = {
    "closed_batch": {
        "query_encode.device_ms_per_batch": "ms/batch",
        "query_encode.idle_ms_per_batch": "ms/batch",
        "query_encode.launches_per_batch": "launches/batch",
        "candidates.device_ms_per_batch": "ms/batch",
        "rerank.device_ms_per_batch": "ms/batch",
        "index_search.idle_ms_per_batch": "ms/batch",
        "index_search.host_reads_per_batch": "reads/batch",
        "candidates.valid_share": "%",
    },
    "build": {"build.index_idle_ms_per_kdoc": "ms/kdoc"},
}


def events(prof, window_name: str):
    """The profiler's events as plain tuples: (window (start, end) ns of
    the range ``window_name``, spans [(start, end, name)] of the
    program, runtime calls {correlation id: start}, device activities
    [(start, end, correlation id, name)])."""
    from torch.autograd import DeviceType
    window, spans, calls, device = None, [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                               name))
        elif name.startswith(PREFIXES):
            spans.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith("cu"):
            calls[e.correlation_id()] = e.start_ns()
        elif name == window_name and window is None:
            window = (e.start_ns(), e.end_ns())
    if window is None:
        raise RuntimeError(f"the trace holds no {window_name} range")
    return window, spans, calls, device


def _innermost(spans):
    """Disjoint [start, end, name] pieces of time, each under the
    innermost open span (the latest started; of two started together,
    the shorter)."""
    spans = sorted(spans)
    bounds = sorted({x for s, t, _ in spans for x in (s, t)})
    open_, out, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][0] <= a:
            s, t, name = spans[i]
            heapq.heappush(open_, (-s, t, name))
            i += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        if not open_:
            continue
        name = open_[0][2]
        if out and out[-1][1] == a and out[-1][2] == name:
            out[-1][1] = b
        else:
            out.append([a, b, name])
    return out


def _idle(window, device):
    """The window's stretches with no device activity, in order."""
    w0, w1 = window
    busy = sorted((max(s, w0), min(t, w1)) for s, t, _, _ in device
                  if min(t, w1) > max(s, w0))
    out, edge = [], w0
    for s, t in busy:
        if s > edge:
            out.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        out.append((edge, w1))
    return out


def _row():
    return {"count": 0, "host_s": 0.0, "device_s": 0.0, "launches": 0,
            "idle_s": 0.0}


def span_table(window, spans, calls, device) -> dict:
    """Per-span results of the window (module docstring), and
    ``outside``."""
    w0, w1 = window
    table = {"outside": _row()}
    for s, t, name in spans:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            row = table.setdefault(name, _row())
            row["count"] += 1
            row["host_s"] += (t - s) * 1e-9
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]

    def owner(at):
        i = bisect_right(starts, at) - 1
        if i >= 0 and at < pieces[i][1]:
            return pieces[i][2]
        return "outside"

    for s, t, corr, name in device:
        s, t = max(s, w0), min(t, w1)
        if t < s:           # outside the window (a kernel may last 0 ns)
            continue
        at = calls.get(corr)
        row = table.setdefault("outside" if at is None else owner(at),
                               _row())
        row["device_s"] += (t - s) * 1e-9
        row["launches"] += 0 if name.startswith(COPIES) else 1
    idle = _idle(window, device)
    outside = sum(t - s for s, t in idle)
    j = 0
    for s, t, name in pieces:
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < t:
            cut = min(t, idle[k][1]) - max(s, idle[k][0])
            if cut > 0:
                table.setdefault(name, _row())["idle_s"] += cut * 1e-9
                outside -= cut
            k += 1
    table["outside"]["idle_s"] = outside * 1e-9
    return table


# ---------------------------------------------------------------- readers

def span_total(ctx, names, key):
    """``key`` summed over the spans ``names`` of ``ctx["program_spans"]``,
    or None where the context has no table."""
    table = ctx.get("program_spans")
    if not table:
        return None
    return sum(table[n][key] for n in names if n in table)


def per_span(ctx, names, key, per: str, scale: float = 1.0):
    """``span_total`` over the count of the span ``per`` (None where it
    did not run), times ``scale``."""
    total = span_total(ctx, names, key)
    n = (ctx.get("program_spans") or {}).get(per, {}).get("count", 0)
    if total is None or not n:
        return None
    return scale * total / n


def counter_ratio(ctx, num: str, den: str, scale: float = 1.0):
    c = ctx.get("program_counters") or {}
    if not c.get(den) or num not in c:
        return None
    return scale * c[num] / c[den]


# ---------------------------------------------------------------- the run

def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def span_cost_us(n: int = 100_000) -> dict:
    """Host microseconds of entering and leaving one span, with no
    profiler session and inside the traced run's."""
    from bench.trace import profiler
    from repro_torch.trace import span

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("search.cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    off = loop()
    with profiler():
        on = loop()
    return {"off": off, "on": on}


def traced_run(spec: dict, seed: int, seconds: float, device,
               cost: bool = False):
    """Set up the cell and run its traced window as ``bench/run.py``
    does, the program's counting window open; -> (the line to print:
    the metrics, the table, the counters and, with ``cost``, the
    end-to-end metric of untraced windows first; the readers'
    context)."""
    import torch
    from torch.profiler import record_function
    from bench import jobs, roofline
    from bench.run import read_metric
    from bench.trace import WINDOW, profiler, summary
    from repro_torch.trace import counting

    cuda = torch.device(device).type == "cuda"
    kind = spec["traffic"]["kind"]
    work_dir = spec.get("work_dir") or str(ROOT / "build" / "bench"
                                           / spec["name"])
    job = jobs.KINDS[kind](spec["name"], spec["cfg"], spec["traffic"],
                           seed, device, work_dir)
    job.setup()
    _sync(torch)
    out = {"workload": spec["name"], "seed": seed,
           "device": torch.cuda.get_device_name() if cuda else "cpu"}
    if cost:
        e2e = {}
        job.window(seconds)
        e2e["plain"] = job.end_to_end()
        with counting():
            job.window(seconds)
        e2e["counting"] = job.end_to_end()
        with profiler():
            job.window(seconds)
            _sync(torch)
        e2e["profiled"] = job.end_to_end()
        out["cost"] = {"end_to_end": e2e, "span_us": span_cost_us()}
    with profiler() as prof, roofline.Capture() as cap, \
            counting() as counters:
        with record_function(WINDOW):
            job.window(seconds, traced=True)
        _sync(torch)
    summ = summary(prof)
    table = span_table(*events(prof, WINDOW))
    job.fill_ctx()
    ctx = dict(job.ctx, window_s=job.wall_s, busy_s=summ["busy_s"],
               trace_window_s=summ["window_s"], kernel_s=summ["kernel_s"],
               counts=cap.totals(), program_spans=table,
               program_counters=counters)
    names = [m["name"] for m in spec["per_layer"]]
    names += list(PROGRAM_METRICS.get(kind, {}))
    out["metrics"] = {n: read_metric(n, ctx) for n in names}
    out.update(busy_s=summ["busy_s"], window_s=summ["window_s"],
               program_spans=table, program_counters=counters,
               idle_gaps=summ["idle_gaps"])
    job.release()
    return out, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spans: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.run import cell_spec, load_json
    spec = cell_spec(load_json(ROOT / "BENCHMARK.json"), args.workload)
    out, _ = traced_run(spec, args.seed, args.seconds, "cuda",
                        bool(args.cost))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
