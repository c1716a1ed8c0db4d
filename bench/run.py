#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print one JSON
line of results.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: the cell names its configuration
(``bench/configs/<config>.json``) and its traffic
(``bench/traffic/<traffic>.json``, whose ``kind`` picks the job in
``bench/jobs.py``); its limits are ``bench/limits/<cell>.json`` and each
per-layer metric is read by ``bench/metrics/<metric>.py``. The run makes
its inputs and weights from the seed, warms every shape (``setup_s``
runs from the process's start to the first timed operation), measures
for ``--seconds``, and then judges what the timed path produced against
the plain reference (``bench/reference``): ``correct`` holds where each
number compared is within its limit. ``--trace 1`` records the window
with ``torch.profiler`` and prints the per-layer metrics instead of the
end-to-end ones.

It exits non-zero without a result where there is no CUDA card (or
fewer than the cell asks for), and where the process has loaded JAX or
the JAX package by the time the window has closed. The kernels build
into ``build/kernels`` inside the checkout; the build artifacts of the
``build`` kind go to ``build/bench/<cell>`` and are overwritten by each
build.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(bench: dict, name: str) -> dict:
    """Everything one cell needs, found by the names in ``BENCHMARK.json``:
    the cell, its configuration file, its traffic file, its limits, and
    its end-to-end and per-layer metric entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}

    def applies(m):
        return (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)

    return dict(
        name=name, chips=int(cell["chips"]),
        cfg=load_json(ROOT / config["file"]),
        traffic=load_json(ROOT / "bench" / "traffic"
                          / f"{cell['traffic']}.json"),
        limits=load_json(ROOT / "bench" / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def read_metric(name: str, ctx: dict):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: str = None):
    """Set up, measure and judge one cell (``cell_spec``); -> (result
    dict, numbers compared, readings). ``control`` ("fp8") puts the
    reference in that precision in the program's place for the
    judgement."""
    import torch
    from bench import jobs
    from bench.reference.check import Reference

    name, cfg, traffic = spec["name"], spec["cfg"], spec["traffic"]
    limits, e2e, layer = spec["limits"], spec["end_to_end"], spec["per_layer"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    work_dir = spec.get("work_dir") or str(ROOT / "build" / "bench" / name)
    job = jobs.KINDS[traffic["kind"]](name, cfg, traffic, seed, device,
                                      work_dir)
    job.setup()
    if cuda:
        torch.cuda.synchronize()
    # what set-up made stays for the run: out of the collector's walks
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        from torch.profiler import record_function
        from bench import roofline
        from bench.trace import profiler, summary
        with profiler() as prof, roofline.Capture() as cap:
            with record_function("bench.window"):
                job.window(seconds, traced=True)
            if cuda:
                torch.cuda.synchronize()
        summ = summary(prof)
        job.fill_ctx()
        ctx = dict(job.ctx, window_s=job.wall_s, busy_s=summ["busy_s"],
                   trace_window_s=summ["window_s"],
                   kernel_s=summ["kernel_s"], counts=cap.totals())
        units = {m["name"]: m["unit"] for m in layer}
        for m in layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        breakdown = {"device_ops": summ["device_ops"],
                     "idle_gaps": summ["idle_gaps"]}
        dev_extra = {"busy_s": summ["busy_s"], "window_s": summ["window_s"]}
    else:
        job.window(seconds)
        values = dict(job.end_to_end(), setup_s=(setup_s, "s"))
        for m in e2e:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": unit}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    t_check = time.perf_counter()
    job.keep_state()
    job.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference("f32", job.weights, cfg)
    if control:
        from bench.reference import check
        judge = (check.judge_build if traffic["kind"] == "build"
                 else check.judge_search)
        numbers, readings = judge(job, ref, Reference(control, job.weights,
                                                       cfg))
    else:
        numbers, readings = job.judge(ref)
    readings = dict(readings, setup_parts=job.parts,
                    check_s=time.perf_counter() - t_check)
    correct = all(numbers[k] <= limits[k] for k in numbers)
    result = {"correct": bool(correct), "attempted": int(job.attempted),
              "failed": int(job.failed), "metrics": metrics,
              "device": dict(platform="gpu" if cuda else "cpu",
                             kind=(torch.cuda.get_device_name()
                                   if cuda else "cpu"),
                             count=spec["chips"],
                             memory_peak_bytes=int(peak), **dev_extra)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": _num(v), "limit": limits[k]}
                       for k, v in numbers.items()}
    return result, numbers, readings


def _num(v):
    v = float(v)
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA device available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"bench: {spec['chips']} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    result, numbers, readings = run_cell(
        spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    limits = spec["limits"]
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BANNED)
    if loaded:
        print(f"bench: the process loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("readings: " + json.dumps(readings), file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k}: {v} (limit {limits[k]})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
