"""Dry run of every (arch x cell) step over the production mesh, on
``meta`` tensors (``src/repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for its mesh and
reads XLA's memory and cost analyses. The port has no compiler to ask;
it runs each step on ``meta`` tensors (shapes and dtypes, no data:
nothing allocates, on any machine) with the mesh's ranks from torch's
fake process group (256 ranks, or 512 ``--multi-pod``; no traffic), and
counts what the ops it dispatches would do (``roofline/analysis.py``
``TraceCounter``). It touches no card. Per cell:

1. specs: every argument leaf (parameters, optimizer state or a decode
   cache, batch) laid out as a ``meta`` DTensor by its spec
   (``sharding/params.py`` ``to_placements``, the reference's
   ``to_shardings``, then ``distribute_meta``); per-rank bytes are rank
   0's local shards (the largest: ``Shard`` splits as ``torch.chunk``
   does), an uneven split's padding included and listed (``uneven``),
   their sum the reference's ``argument_size_in_bytes``;
2. the step on ``meta`` at the cell's global shapes: FLOPs, bytes
   accessed, output bytes and the peak of live activation bytes (by
   tensor lifetimes, ``TraceCounter``), and their even split over the
   ranks, labelled so;
3. one rank's program: the step with its parameters, optimizer state and
   batch as those DTensors, under ``mesh_context(mesh, rules)`` and
   ``implicit_replication()`` (``rank_context``), the models' sharding
   annotations (the reference's ``constrain`` sites) laying out their
   activations as the reference's rules say: collective bytes by op,
   per-rank FLOPs, bytes and activation peak, and the largest single
   collective's bytes.

A cell is ``ok`` when every stage it runs runs to its end, as the
reference's ``ok`` says the partitioner accepted every sharding: a
stage 3 that stops fails the cell (``ok`` False), its op, file and line
kept in ``stage3_stopped`` and printed. The per-rank ``flops`` /
``bytes_accessed`` / ``temp_size_in_bytes`` (the activation peak) a
roofline reads are stage 3's where it ran, else stage 2's even split
(``per_rank_from`` says which; a stage-2-only run).
A decode cell runs at its worst case, the cache full (``pos`` =
seq_len - 1, a host int): decode attends over the whole cache, masked,
so the work counted is the same at every ``pos``.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --cell train_4k
    python -m repro_torch.launch.dryrun --all --include-colbert --json out.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch.input_specs import all_cells, build_cell
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, fake_process_group,
                                     make_mesh)
from repro_torch.roofline.analysis import (TraceCounter,
                                           collective_bytes_from_trace,
                                           nbytes, tensors)
from repro_torch.sharding.api import rank_context
from repro_torch.sharding.params import distribute_meta, to_placements

DOC = __doc__
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _arg_names(kind: str, n: int) -> Sequence[str]:
    if kind == "train":
        return ("params", "opt_state", "batch")
    if kind == "decode":
        return ("params", "cache", "batch")
    return ("params", "batch")[:n]


def _leaves(tree, path=""):
    """(path, tensor) of every tensor leaf of an argument tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path.lstrip("/"), tree


def stage_specs(build, mesh) -> dict:
    """Stage 1: the arguments as ``meta`` DTensors -> their trees and
    rank 0's bytes per argument, the uneven splits with their padding."""
    place = to_placements(mesh, build.in_specs)
    dargs = tuple(distribute_meta(a, mesh, p)
                  for a, p in zip(build.args, place))
    names = _arg_names(build.kind, len(build.args))
    per_arg, uneven = {}, []
    for name, arg, darg in zip(names, build.args, dargs):
        per_arg[name] = 0
        for (path, t), (_, d) in zip(_leaves(arg), _leaves(darg)):
            local = d.to_local()
            per_arg[name] += nbytes(local)
            split = math.prod(mesh.size(i) for i, p in
                              enumerate(d.placements) if p.is_shard())
            if local.numel() * split != t.numel():
                uneven.append({
                    "leaf": f"{name}/{path}", "shape": list(t.shape),
                    "ranks": split, "local": list(local.shape),
                    "pad_bytes": nbytes(local) - nbytes(t) / split})
    return {"dargs": dargs, "arg_bytes": per_arg, "uneven": uneven}


def _step_args(build, args):
    """The step's arguments after the model; a decode batch's ``pos`` the
    worst case, the cache full (seq_len - 1, a host int)."""
    rest = list(args[1:])
    if build.kind == "decode":
        seq = build.args[1]["k"].shape[2]
        rest[-1] = dict(rest[-1], pos=seq - 1)
    return rest


def _keep(build, *trees):
    return [list(build.model.parameters()), list(build.model.buffers()),
            build.args, *trees]


def stage_global(build) -> dict:
    """Stage 2: the step on ``meta`` at the cell's global shapes."""
    counter = TraceCounter(_keep(build))
    with counter:
        out = build.fn(build.model, *_step_args(build, build.args))
    return {"flops": counter.flops, "bytes_accessed": counter.bytes_accessed,
            "output_bytes": nbytes(out),
            "activation_peak_bytes": counter.peak_bytes,
            "n_ops": counter.n_ops}


def _distribute_model(model: nn.Module, groups, dgroups) -> None:
    """The model's parameters replaced, in place, by the DTensors laid
    out for its groups (``train/params.py``: a stack one a layer)."""
    by_id = {}
    for path, v in groups.items():
        if isinstance(v, (list, tuple)):
            by_id.update({id(t): d for t, d in zip(v, dgroups[path])})
        else:
            by_id[id(v)] = dgroups[path]
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(by_id[id(p)], requires_grad=p.requires_grad))


def _where(exc: BaseException) -> str:
    """The innermost frame of the port's code a traceback went through."""
    frames = traceback.extract_tb(exc.__traceback__)
    tools = (os.path.join("launch", "dryrun.py"),
             os.path.join("roofline", "analysis.py"))
    own = [f for f in frames if os.path.abspath(f.filename).startswith(
        os.path.join(_SRC, "repro_torch")) and not f.filename.endswith(tools)]
    f = (own or frames)[-1]
    return f"{os.path.relpath(os.path.abspath(f.filename), _SRC)}:{f.lineno}"


def stage_rank(build, mesh, dargs) -> dict:
    """Stage 3: one rank's program over DTensors -> its collectives,
    FLOPs, bytes and activation peak, or where DTensor stopped."""
    from torch.distributed.tensor import DTensor
    _distribute_model(build.model, build.args[0], dargs[0])
    counter = TraceCounter(_keep(build, dargs))
    try:
        with counter, rank_context(mesh, build.rules):
            out = build.fn(build.model, *_step_args(build, dargs))
    except Exception as e:                       # noqa: BLE001 - reported
        return {"collectives": None, "stopped": {
            "op": counter.last_op, "where": _where(e),
            "error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
            if str(e) else type(e).__name__}}
    local = [t.to_local() if isinstance(t, DTensor) else t
             for t in tensors(out)]
    coll = collective_bytes_from_trace(counter)
    return {"collectives": coll["by_op"], "collective_bytes": coll["total"],
            "largest_collective_bytes": counter.largest_collective,
            "flops": counter.flops, "bytes_accessed": counter.bytes_accessed,
            "output_bytes": nbytes(local),
            "activation_peak_bytes": counter.peak_bytes, "stopped": None}


def run_cell(arch: str, cell: str, *, multi_pod: bool = False,
             verbose: bool = True, unroll: bool = False,
             layers_override: Optional[int] = None, cfg_overrides=None,
             rules_overrides=None, mesh_shape: Optional[Sequence[int]] = None,
             stages: int = 3) -> dict:
    """Stages 1 to ``stages`` of one cell over a fake group of the mesh's
    ranks, opened and closed around the call (none may be open).
    ``mesh_shape`` replaces the production shape, on its axis names (a
    (1, 1) mesh: one rank's view, where per rank is global). Figures of
    a stage not run are None."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    if mesh_shape is not None:
        shape = tuple(int(s) for s in mesh_shape)
    n_dev = math.prod(shape)
    secs = [0.0, 0.0, 0.0]
    glob = rank = None
    with fake_process_group(n_dev):
        mesh = make_mesh(shape, axes, "cpu")
        t0 = time.time()
        build = build_cell(arch, cell, mesh, unroll=unroll,
                           layers_override=layers_override,
                           cfg_overrides=cfg_overrides,
                           rules_overrides=rules_overrides)
        specs = stage_specs(build, mesh)
        secs[0] = time.time() - t0
        if stages >= 2:
            t0 = time.time()
            glob = stage_global(build)
            secs[1] = time.time() - t0
        if stages >= 3:
            t0 = time.time()
            rank = stage_rank(build, mesh, specs["dargs"])
            secs[2] = time.time() - t0
    note = build.note
    if build.kind == "decode":
        note = "; ".join(x for x in (note, "pos = seq_len - 1 (the cache "
                                     "full)") if x)
    stopped = rank is not None and rank["stopped"] is not None
    result = {
        "arch": arch, "cell": cell, "kind": build.kind, "ok": not stopped,
        "mesh": "x".join(str(s) for s in shape), "n_devices": n_dev,
        "stage_s": [round(t, 2) for t in secs], "note": note,
        "arg_bytes": specs["arg_bytes"],
        "argument_size_in_bytes": sum(specs["arg_bytes"].values()),
        "uneven": specs["uneven"],
        "padding_bytes": sum(u["pad_bytes"] for u in specs["uneven"]),
        "global": glob, "even_split": None, "per_rank": None,
        "per_rank_from": None, "collectives": None,
        "collective_bytes": None, "largest_collective_bytes": None,
        "stage3_stopped": None,
    }
    for key in ("flops", "bytes_accessed", "output_size_in_bytes",
                "temp_size_in_bytes"):
        result[key] = None
    if glob is not None:
        even = {k: glob[k] / n_dev for k in _FIGURES}
        ran = rank is not None and rank["stopped"] is None
        src = rank if ran else even
        result.update(
            even_split=even,
            per_rank={k: rank[k] for k in _FIGURES} if ran else None,
            per_rank_from="stage 3" if ran else "even split",
            flops=float(src["flops"]),
            bytes_accessed=float(src["bytes_accessed"]),
            output_size_in_bytes=float(src["output_bytes"]),
            temp_size_in_bytes=float(src["activation_peak_bytes"]))
    if rank is not None:
        result.update(collectives=rank["collectives"],
                      collective_bytes=rank.get("collective_bytes"),
                      largest_collective_bytes=rank.get(
                          "largest_collective_bytes"),
                      stage3_stopped=rank["stopped"])
    if verbose:
        _print_cell(result)
    return result


_FIGURES = ("flops", "bytes_accessed", "output_bytes",
            "activation_peak_bytes")


def _print_cell(r: dict) -> None:
    s1, s2, s3 = r["stage_s"]
    print(f"[{r['arch']} / {r['cell']} @ {r['mesh']}] stage 1 {s1:.1f}s, "
          f"stage 2 {s2:.1f}s, stage 3 {s3:.1f}s")
    if r["global"] is not None:
        g = r["global"]
        stop = r["stage3_stopped"]
        if stop is not None:
            coll = f"stage 3 stopped at {stop['where']} ({stop['op']})"
        elif r["collective_bytes"] is None:
            coll = "stage 3 not run"
        else:
            coll = (f"collective_bytes={r['collective_bytes']:.3e} (largest "
                    f"{r['largest_collective_bytes']:.3e})")
        print(f"  global flops={g['flops']:.3e} "
              f"bytes={g['bytes_accessed']:.3e}; per rank "
              f"({r['per_rank_from']}) flops={r['flops']:.3e} "
              f"bytes={r['bytes_accessed']:.3e} {coll}")
    act = ("" if r["temp_size_in_bytes"] is None else
           f" activations={r['temp_size_in_bytes'] / 2**30:.2f}GiB "
           f"out={r['output_size_in_bytes'] / 2**30:.2f}GiB")
    print(f"  per rank: args={r['argument_size_in_bytes'] / 2**30:.2f}GiB "
          f"(padding {r['padding_bytes'] / 2**30:.4f}GiB){act}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=DOC.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--include-colbert", action="store_true",
                    help="also run the paper's own index/search cells")
    ap.add_argument("--json", default=None)
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's analysis mode (a prefill cell's "
                         "attention in 8 chunks; the same FLOPs)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of every trunk (default: the config's)")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch else
             ASSIGNED_ARCHS + (["colbertv2"] if args.include_colbert else []))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results, failures = [], []
    for arch in archs:
        cells = [args.cell] if args.cell else all_cells(arch)
        for cell in cells:
            for mp in meshes:
                try:
                    results.append(run_cell(arch, cell, multi_pod=mp,
                                            unroll=args.unroll,
                                            layers_override=args.layers))
                except Exception as e:
                    traceback.print_exc()
                    failures.append({"arch": arch, "cell": cell,
                                     "multi_pod": mp, "error": repr(e)})
    counted = sum(r["collectives"] is not None for r in results)
    stops = [r for r in results if not r["ok"]]
    print(f"\n=== dry-run: {len(results) - len(stops)} ok, "
          f"{len(failures) + len(stops)} failed, collectives counted for "
          f"{counted} ===")
    for r in stops:
        s = r["stage3_stopped"]
        print(f"FAILED: {r['arch']} {r['cell']}: stage 3 stopped at "
              f"{s['where']} ({s['op']}): {s['error']}")
    for f in failures:
        print("FAILED:", f["arch"], f["cell"],
              "multi_pod" if f["multi_pod"] else "single_pod", f["error"])
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"results": results, "failures": failures}, fh,
                      indent=1)
    return 1 if failures or stops else 0


if __name__ == "__main__":
    sys.exit(main())
