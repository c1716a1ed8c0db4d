#!/usr/bin/env python3
"""The numbers the check compares, on many seeds in one process: the
program's (``--seeds``) and each control's in its place (``--controls``
on ``--control-seeds``: fp8 for the encoder, tf32 for the index
stages), each run set up, measured for ``--seconds`` at the cell's own
load and judged as ``run.py`` does. Prints one JSON line
a run; the limits of ``bench/limits/<cell>.json`` are set from these
readings (``PERF.md``).

    python3 bench/readings.py --workload colbertv2.build \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3
"""
import argparse
import gc
import json
import sys
import time

from run import ROOT, cell_spec, load_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="fp8,tf32")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from run import run_cell
    spec = cell_spec(load_json(ROOT / "BENCHMARK.json"), args.workload)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), c) for c in args.controls.split(",") if c
             for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        result, numbers, readings = run_cell(spec, seed, args.seconds, False,
                                             "cuda", t0, control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "numbers": numbers,
                          "readings": readings,
                          "correct": result["correct"],
                          "metrics": result["metrics"],
                          "run_s": time.perf_counter() - t0}), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
