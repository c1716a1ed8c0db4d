"""Render the dry-run and roofline tables from the runners' JSON
(``src/repro/roofline/report.py``): ``launch/dryrun.py --json`` (one
row a cell: ``cells_table``) or ``roofline/run.py --json`` (its
full-depth stage 1 rows, its terms, its collectives extrapolated to
full depth).

    PYTHONPATH=src python -m repro_torch.roofline.report roofline.json

The "fits" column holds a rank's arguments plus its activation peak to
the card's memory (``hw.HBM_BYTES``, the H100's 80 GB); a cell without
an activation figure (stage 1 only) is held on its arguments.
"""
from __future__ import annotations

import json
import sys

from repro_torch.roofline import hw

GIB = 2 ** 30


def _mem_line(r: dict) -> str:
    args = r.get("argument_size_in_bytes", 0) / GIB
    temp = (r.get("temp_size_in_bytes") or 0) / GIB
    out = (r.get("output_size_in_bytes") or 0) / GIB
    tot = args + temp
    fits = "yes" if tot <= hw.HBM_BYTES / GIB else "**NO**"
    return f"{args:7.2f} | {temp:7.2f} | {out:7.2f} | {fits}"


def dryrun_table(results: list) -> str:
    rows = ["| arch | cell | mesh | args GiB | activations GiB | "
            "out GiB | fits 80 GB |",
            "|---|---|---|---|---|---|---|"]
    for r in results:
        runs = ([r] if "argument_size_in_bytes" in r else
                [r[k] for k in ("single_pod", "multi_pod") if k in r])
        for d in runs:
            rows.append(
                f"| {r['arch']} | {r['cell']} | {d['mesh']} | "
                f"{_mem_line(d)} |")
    return "\n".join(rows)


def cells_table(results: list) -> str:
    """One row a dry-run cell (``launch/dryrun.py --json``): rank 0's
    parameter, optimizer-state, batch (a decode cache with it) and
    activation GB (decimal), whether they fit the card, the step's
    global FLOPs, and its collectives or where stage 3 stopped."""
    rows = ["| arch | cell | params GB | opt GB | batch GB | activations "
            "GB | fits 80 GB | FLOPs (global) | collectives a rank |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        a = r["arg_bytes"]
        stop = r["stage3_stopped"]
        if stop is not None:
            coll = f"stage 3 stopped: `{stop['where']}` {stop['op']}"
        else:
            coll = ", ".join(f"{op} {e['bytes'] / 1e9:.3g} GB x{e['count']}"
                             for op, e in r["collectives"].items()) or "none"
        act = r["temp_size_in_bytes"]
        fits = r["argument_size_in_bytes"] + act <= hw.HBM_BYTES
        src = "" if r["per_rank_from"] == "stage 3" else " (even split)"
        rows.append(
            f"| {r['arch']} | {r['cell']} | {a['params'] / 1e9:.3f} | "
            f"{a.get('opt_state', 0) / 1e9:.3f} | "
            f"{(a['batch'] + a.get('cache', 0)) / 1e9:.3f} | "
            f"{act / 1e9:.3f}{src} | {'yes' if fits else '**NO**'} | "
            f"{r['global']['flops']:.3e} | {coll} |")
    return "\n".join(rows)


def roofline_table(results: list) -> str:
    rows = ["| arch | cell | compute_s | memory_s | collective_s | "
            "bottleneck | useful/traced | MFU@roof |",
            "|---|---|---|---|---|---|---|---|"]
    for r in results:
        t = r["terms"]
        coll = ("missing (stage 3 stopped)" if t["collective_s"] is None
                else f"{t['collective_s']:.2e}")
        rows.append(
            f"| {r['arch']} | {r['cell']} | {t['compute_s']:.2e} | "
            f"{t['memory_s']:.2e} | {coll} | "
            f"**{t['bottleneck']}** | {t['useful_flops_frac']:.1%} | "
            f"{t['mfu']:.1%} |")
    return "\n".join(rows)


def collective_summary(results: list) -> str:
    rows = ["| arch | cell | all-reduce | all-gather | reduce-scatter | "
            "all-to-all | broadcast |", "|---|---|---|---|---|---|---|"]
    for r in results:
        c = r.get("collectives")

        def fmt(op):
            if c is None:
                return "stage 3 stopped"
            e = c.get(op)
            return f"{e['bytes']/2**20:.0f}M x{e['count']}" if e else "-"
        rows.append(
            f"| {r['arch']} | {r['cell']} | {fmt('all-reduce')} | "
            f"{fmt('all-gather')} | {fmt('reduce-scatter')} | "
            f"{fmt('all-to-all')} | {fmt('broadcast')} |")
    return "\n".join(rows)


def main(argv=None):
    path = (argv or sys.argv[1:])[0]
    with open(path) as f:
        data = json.load(f)
    results = data["results"]
    if results and "terms" not in results[0]:       # the dry run's JSON
        print("## Dry-run cells (a rank's figures)\n")
        print(cells_table(results))
        return 0
    print("## Dry-run matrix\n")
    print(dryrun_table(results))
    print("\n## Roofline terms (single-pod, 256 ranks, H100)\n")
    print(roofline_table(results))
    print("\n## Collective traffic per step (single-pod)\n")
    print(collective_summary(results))
    if data.get("failures"):
        print("\n## Failures\n")
        for f_ in data["failures"]:
            print("-", f_)
    return 0


if __name__ == "__main__":
    sys.exit(main())
