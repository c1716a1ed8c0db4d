"""Hillclimb harness: run a named VARIANT of a cell and diff its
roofline figures against the baseline (``src/repro/roofline/hillclimb.py``).

    python -m repro_torch.roofline.hillclimb --arch kimi-k2-1t-a32b \
        --cell train_4k --variant seqpar

Each variant is a (cfg_overrides, rules_overrides) pair, a hypothesis
about what moves the dominant term, applied without touching model code
(``launch/input_specs.py`` ``build_cell`` takes both). ``VARIANTS`` are
the reference's: ``recsys_fieldshard``'s ``param_rules`` is read by
nothing, there as here; ``moe_ep`` routes the MoE layers through the
port's all-to-all (``models/moe.py`` ``moe_ep``); the ``maxsim_blocked``
variants change what the ColBERT search step's trace holds (its doc
blocks of ``maxsim_block``).
"""

import argparse
import json
import sys

from repro_torch.launch.dryrun import run_cell
from repro_torch.roofline.run import EXTRAPOLATED

DOC = __doc__                       # the reference's name for the usage text

# variant -> dict(cfg=..., rules=..., note=...)
VARIANTS = {
    # Megatron-style sequence parallelism: residual-stream activations
    # sharded on seq over the TP axis (all-gather before attn/mlp,
    # reduce-scatter after) — targets activation memory + HBM traffic.
    "seqpar": dict(
        rules={"seq": "model"},
        note="residual stream seq-sharded over TP"),
    # smaller grad-accum microbatches: less live activation per microbatch
    "micro16": dict(cfg={"train_microbatches": 16},
                    note="16 grad-accum microbatches"),
    "micro2": dict(cfg={"train_microbatches": 2},
                   note="2 grad-accum microbatches"),
    # bigger attention chunks for prefill (fewer scan steps, same flops)
    "chunk4k": dict(cfg={"attn_chunk": 4096}, note="attn chunks 4096"),
    "chunk8k": dict(cfg={"attn_chunk": 8192}, note="attn chunks 8192"),
    # decode: bf16 -> f32 cache would double memory; try keeping scores
    # bf16 end to end (dtype experiment)
    "nopremat": dict(cfg={"remat": False}, note="remat off"),
    # GNN: shard edge/triplet tables on data only (model axis free for
    # feature dim), vs the data+model default
    "gnn_dataonly": dict(
        rules={"edges": "data", "triplets": "data"},
        note="edge/triplet tables sharded on data only"),
    # rows on data, FEATURE dim on model: irregular gathers only
    # all-gather over data (operand [E, h/16] instead of [E, h])
    "gnn_hshard": dict(
        rules={"edges": "data", "triplets": "data", "hidden": "model"},
        note="edge rows on data, feature dim on model"),
    # RecSys: shard embedding tables on the FIELD axis instead of rows
    "recsys_fieldshard": dict(
        rules={"vocab_rows": None},
        param_rules="field",
        note="tables sharded by field, rows replicated"),
    # MoE: expert-parallel all-to-all dispatch (shard_map) instead of the
    # capacity-buffer scatter the partitioner turns into all-reduces
    "moe_ep": dict(cfg={"moe_impl": "ep"},
                   note="EP all-to-all dispatch via shard_map"),
    "moe_ep_micro2": dict(cfg={"moe_impl": "ep", "train_microbatches": 2},
                          note="EP dispatch + 2 microbatches"),
    # ColBERT search: streamed doc blocks, no materialized score tensor
    "maxsim_blocked": dict(cfg={"maxsim_impl": "blocked"},
                           note="blocked MaxSim (no [Nq,Nd,Lq,Ld] in HBM)"),
    "maxsim_blocked_2k": dict(cfg={"maxsim_impl": "blocked",
                                   "maxsim_block": 2048},
                              note="blocked MaxSim, 2048-doc blocks"),
    # ColBERT search: shard the query batch over data for the encoder
    # (baseline encodes every query on every chip), all-gather the tiny
    # [Nq, Lq, 128] result before MaxSim
    "qshard": dict(rules={"queries": "data"},
                   note="query encode sharded over data"),
    "qshard_blocked": dict(rules={"queries": "data"},
                           cfg={"maxsim_impl": "blocked"},
                           note="query-sharded encode + blocked MaxSim"),
    # ColBERT search: shard the doc set over BOTH mesh axes (baseline
    # leaves the model axis idle -> 16/256 of the machine works)
    "docs2d": dict(rules={"docs": ("data", "model")},
                   note="docs sharded over data x model"),
    "docs2d_blocked": dict(rules={"docs": ("data", "model")},
                           cfg={"maxsim_impl": "blocked",
                                "maxsim_block": 256},
                           note="docs over both axes + blocked MaxSim"),
    "docs2d_blocked_qshard": dict(
        rules={"docs": ("data", "model"), "queries": "data"},
        cfg={"maxsim_impl": "blocked", "maxsim_block": 256},
        note="docs 2d + blocked + query-sharded encode"),
}


def run_variant(arch: str, cell: str, variant: str, *, unroll_L=(2, 4),
                full_L: int | None = None, multi_pod=False) -> dict:
    spec = VARIANTS[variant]
    kw = dict(cfg_overrides=spec.get("cfg"),
              rules_overrides=spec.get("rules"))
    out = {"variant": variant, "note": spec.get("note", "")}
    # argument bytes (stage 1) at the config's depth
    r = run_cell(arch, cell, multi_pod=multi_pod, verbose=False, stages=1,
                 **kw)
    out["scanned"] = {k: r.get(k) for k in
                      ("argument_size_in_bytes", "padding_bytes")}
    # cost extrapolation (traced at two layer counts)
    if full_L and full_L > max(unroll_L):
        a = run_cell(arch, cell, unroll=True, layers_override=unroll_L[0],
                     verbose=False, **kw)
        b = run_cell(arch, cell, unroll=True, layers_override=unroll_L[1],
                     verbose=False, **kw)
        span = unroll_L[1] - unroll_L[0]
        ex = {}
        for key in EXTRAPOLATED:
            if a[key] is None or b[key] is None:
                ex[key] = None
                continue
            per_l = (b[key] - a[key]) / span
            ex[key] = max(a[key] + (full_L - unroll_L[0]) * per_l, 0.0)
        out["extrapolated"] = ex
    else:
        c = run_cell(arch, cell, unroll=True, verbose=False, **kw)
        out["extrapolated"] = {k: c[k] for k in EXTRAPOLATED}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=DOC.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--full-layers", type=int, default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run_variant(args.arch, args.cell, args.variant,
                      full_L=args.full_layers)
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
