"""Roofline runner: every (arch x cell) priced on the H100
(``src/repro/roofline/run.py``).

Per cell:
  1. the dry run's stage 1 at full depth, single-pod and multi-pod
     (``launch/dryrun.py``): per-rank argument bytes, which the report
     holds to the card's 80 GB;
  2. the traced stages at 2 and 4 layers, linearly extrapolated to the
     full layer count: per-rank FLOPs, bytes accessed and collective
     bytes. Every layer of a trunk dispatches the same ops, so the
     2-to-4 difference is the exact per-layer marginal, and the
     extrapolation equals a full-depth trace (a full-depth ``meta`` trace
     of a 48-layer trunk at 32k takes minutes: its time grows with the op
     count). The traces run in the reference's analysis mode (``unroll``:
     a prefill cell's attention in 8 chunks). Where stage 3 stopped,
     the per-rank figures are the even split and the collective bytes
     and term missing (None; ``collectives_counted`` False);
  3. three roofline terms + MODEL_FLOPS (analytic 6ND/2ND, the
     reference's ``_model_flops``) + bottleneck.

Emits JSON and a table row a cell.

    python -m repro_torch.roofline.run --arch qwen3-0.6b --json roofline.json
    python -m repro_torch.roofline.run --kernel packed_rerank
"""

import argparse
import json
import sys
import traceback

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import (ColbertConfig, DimeNetConfig,
                                      RecsysConfig, TransformerConfig)
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.input_specs import all_cells
from repro_torch.roofline.analysis import HEADER, RooflineTerms

DOC = __doc__
EXTRAPOLATED = ("flops", "bytes_accessed", "collective_bytes")


def _full_layers(cfg) -> int:
    if isinstance(cfg, TransformerConfig):
        return cfg.n_layers
    if isinstance(cfg, DimeNetConfig):
        return cfg.n_blocks
    if isinstance(cfg, ColbertConfig):
        return cfg.trunk.n_layers
    return 0


def _model_flops(arch: str, cell: str, n_chips: int) -> float:
    """Analytic useful flops per chip for the cell (6ND train / 2ND fwd,
    plus exact attention-matmul terms)."""
    cfg = get_config(arch)
    if isinstance(cfg, TransformerConfig):
        from repro_torch.configs.base import LM_SHAPES
        c = {s.name: s for s in LM_SHAPES}[cell]
        seq, gb = c.dim("seq_len"), c.dim("global_batch")
        n_act = cfg.active_param_count()
        L, Hd = cfg.n_layers, cfg.n_heads * cfg.d_head
        if c.kind == "train":
            toks = seq * gb
            attn = 4 * toks * (seq / 2) * Hd * L        # qk+av, causal
            return (6 * n_act * toks + 3 * attn) / n_chips
        if c.kind == "prefill":
            toks = seq * gb
            attn = 4 * toks * (seq / 2) * Hd * L
            return (2 * n_act * toks + attn) / n_chips
        # decode: 1 token/seq against seq-length cache
        attn = 4 * gb * seq * Hd * L
        return (2 * n_act * gb + attn) / n_chips
    if isinstance(cfg, RecsysConfig):
        # MLP-dominated: count MLP + interaction flops analytically
        from repro_torch.configs.base import RECSYS_SHAPES
        c = {s.name: s for s in RECSYS_SHAPES}[cell]
        B = c.dim("batch")
        D = cfg.embed_dim
        f = 0
        if cfg.kind == "dlrm":
            seqs = [(cfg.n_dense,) + tuple(cfg.bot_mlp_dims)]
            n_emb = cfg.n_sparse + 1
            d_top = n_emb * (n_emb - 1) // 2 + cfg.bot_mlp_dims[-1]
            seqs.append((d_top,) + tuple(cfg.top_mlp_dims))
        elif cfg.kind in ("wide_deep", "deepfm"):
            d_in = cfg.n_sparse * D + cfg.n_dense
            seqs = [(d_in,) + tuple(cfg.mlp_dims) + (1,)]
        else:
            seqs = []
        for seq_dims in seqs:
            for a, b in zip(seq_dims[:-1], seq_dims[1:]):
                f += 2 * a * b
        f += 4 * cfg.n_sparse * D                        # fm/interaction-ish
        mult = 3 if c.kind == "train" else 1
        total = mult * f * B
        if cell == "retrieval_cand":
            total += 2 * c.dim("n_candidates") * D * B
        return total / n_chips
    if isinstance(cfg, ColbertConfig):
        from repro_torch.configs.base import COLBERT_SHAPES
        c = {s.name: s for s in COLBERT_SHAPES}[cell]
        n_trunk = cfg.trunk.param_count() + cfg.trunk.d_model * cfg.proj_dim
        if cell == "index_build":
            toks = c.dim("n_docs") * c.dim("doc_len")
            return 2 * n_trunk * toks / n_chips
        # search: query encode + MaxSim over the sharded doc set
        q_toks = c.dim("n_queries") * cfg.query_maxlen
        maxsim = (2 * c.dim("n_queries") * cfg.query_maxlen
                  * c.dim("n_docs") * c.dim("doc_len") * cfg.proj_dim)
        return (2 * n_trunk * q_toks + maxsim) / n_chips
    if isinstance(cfg, DimeNetConfig):
        from repro_torch.launch.input_specs import _gnn_counts
        from repro_torch.configs.base import GNN_SHAPES
        c = {s.name: s for s in GNN_SHAPES}[cell]
        N, E, T = _gnn_counts(c, cfg.triplet_cap)
        h, nb = cfg.d_hidden, cfg.n_bilinear
        per_edge = 6 * h * h * cfg.n_blocks              # msg MLPs
        per_trip = 2 * nb * h * h * cfg.n_blocks         # bilinear einsum
        fwd = E * per_edge + T * per_trip + N * 2 * h * h
        return 3 * fwd / n_chips                         # train
    return 0.0


def extrapolate(a: dict, b: dict, L: int, key: str, span=(2, 4)):
    """``key`` of the runs at ``span`` layers (a, b) carried linearly to
    ``L`` layers (the reference's ``extrap``); None where either is."""
    if a[key] is None or b[key] is None:
        return None
    per_layer = (b[key] - a[key]) / (span[1] - span[0])
    base = a[key] - span[0] * per_layer
    return max(base + L * per_layer, 0.0)


def _extrapolate_collectives(a: dict, b: dict, L: int):
    """Each collective's count and bytes carried to ``L`` layers as
    ``extrapolate`` carries the totals; None where stage 3 stopped."""
    if a["collectives"] is None or b["collectives"] is None:
        return None
    out = {}
    for op in sorted(set(a["collectives"]) | set(b["collectives"])):
        runs = [{k: r["collectives"].get(op, {}).get(k, 0)
                 for k in ("count", "bytes")} for r in (a, b)]
        out[op] = {k: extrapolate(runs[0], runs[1], L, k)
                   for k in ("count", "bytes")}
    return out


def analyse_cell(arch: str, cell: str, *, skip_multipod: bool = False,
                 verbose: bool = True) -> dict:
    cfg = get_config(arch)
    L_full = _full_layers(cfg)
    out = {"arch": arch, "cell": cell}

    # 1. argument bytes at full depth (the dry run's stage 1)
    r1 = run_cell(arch, cell, multi_pod=False, verbose=False, stages=1)
    out["single_pod"] = r1
    if not skip_multipod:
        out["multi_pod"] = run_cell(arch, cell, multi_pod=True,
                                    verbose=False, stages=1)

    # 2. traced cost, extrapolated from 2 and 4 layers
    if L_full > 4:
        a = run_cell(arch, cell, unroll=True, layers_override=2,
                     verbose=False)
        b = run_cell(arch, cell, unroll=True, layers_override=4,
                     verbose=False)
        ex = {k: extrapolate(a, b, L_full, k) for k in EXTRAPOLATED}
        out["extrapolated"] = {"L": L_full, **ex,
                               "L2": {k: a[k] for k in EXTRAPOLATED},
                               "L4": {k: b[k] for k in EXTRAPOLATED}}
        out["collectives"] = _extrapolate_collectives(a, b, L_full)
    else:
        c = run_cell(arch, cell, unroll=True, verbose=False)
        out["extrapolated"] = {"L": L_full,
                               **{k: c[k] for k in EXTRAPOLATED}}
        out["collectives"] = c["collectives"]
    ex = out["extrapolated"]
    out["collectives_counted"] = out["collectives"] is not None

    n_chips = r1["n_devices"]
    terms = RooflineTerms(
        arch=arch, cell=cell, mesh=r1["mesh"], flops=ex["flops"],
        hlo_bytes=ex["bytes_accessed"],
        collective_bytes=ex["collective_bytes"],
        model_flops=_model_flops(arch, cell, n_chips))
    out["terms"] = {
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "bottleneck": terms.bottleneck,
        "model_flops": terms.model_flops,
        "useful_flops_frac": terms.useful_flops_frac, "mfu": terms.mfu,
        "step_time_s": terms.step_time_s,
    }
    if verbose:
        print(terms.row(), flush=True)
    return out


def run_packed_rerank(args) -> int:
    """``--kernel packed_rerank``: roofline rows for the fused
    compressed-domain rerank kernel vs the reconstruction baseline."""
    from repro_torch.roofline.packed import packed_rerank_report
    shape = None
    if args.rerank_shape:
        keys = ("nq", "lq", "s", "ld", "dim", "k_centroids")
        vals = [int(v) for v in args.rerank_shape.split(",")]
        shape = dict(zip(keys, vals))
    bits = tuple(int(b) for b in args.bits.split(",") if b)
    report = packed_rerank_report(shape, bits_list=bits)
    print(HEADER, flush=True)
    for row in report["rows"]:
        print(row.pop("terms").row(), flush=True)
    for row in report["rows"]:
        if row["bits"] is not None:
            print(f"  bits={row['bits']}: "
                  f"{row['doc_bytes_per_token']} B/token vs "
                  f"{report['rows'][0]['doc_bytes_per_token']} B/token "
                  f"recon ({row['doc_bytes_ratio_vs_recon']:.1f}x), "
                  f"stream ratio {row['bytes_ratio_vs_recon']:.1f}x")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


def run_plaid_probe(args) -> int:
    """``--kernel plaid_probe``: roofline rows for the device-resident
    candidate pipeline vs the host-gather (PCIe hop) baseline."""
    from repro_torch.roofline.probe import plaid_probe_report
    shape = None
    if args.probe_shape:
        keys = ("nq", "lq", "k_centroids", "nprobe", "lmax", "c", "ld",
                "dim")
        vals = [int(v) for v in args.probe_shape.split(",")]
        shape = dict(zip(keys, vals))
    report = plaid_probe_report(shape)
    print(HEADER, flush=True)
    for row in report["rows"]:
        print(row.pop("terms").row(), flush=True)
    host, dev = report["rows"]
    print(f"  host hop: {host['host_hop_bytes']} B "
          f"({host['host_hop_s'] * 1e6:.1f} us PCIe) per batch; "
          f"device fused total {dev['total_s'] * 1e6:.1f} us vs host "
          f"{host['total_s'] * 1e6:.1f} us "
          f"({dev['speedup_vs_host']:.2f}x)")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=DOC.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--skip-multipod", action="store_true")
    ap.add_argument("--kernel", default=None,
                    choices=("packed_rerank", "plaid_probe"),
                    help="analyse a hand-written kernel instead of the "
                         "(arch x cell) dry-run grid")
    ap.add_argument("--bits", default="2,4",
                    help="packed_rerank: codec widths to price")
    ap.add_argument("--rerank-shape", default=None,
                    help="packed_rerank: nq,lq,s,ld,dim,k_centroids")
    ap.add_argument("--probe-shape", default=None,
                    help="plaid_probe: nq,lq,k_centroids,nprobe,lmax,"
                         "c,ld,dim")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.kernel == "packed_rerank":
        return run_packed_rerank(args)
    if args.kernel == "plaid_probe":
        return run_plaid_probe(args)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    print(HEADER, flush=True)
    results, failures = [], []
    for arch in archs:
        for cell in ([args.cell] if args.cell else all_cells(arch)):
            try:
                results.append(analyse_cell(
                    arch, cell, skip_multipod=args.skip_multipod))
            except Exception as e:
                traceback.print_exc()
                failures.append({"arch": arch, "cell": cell,
                                 "error": repr(e)})
    print(f"\n{len(results)} cells analysed, {len(failures)} failed")
    for f in failures:
        print("FAILED:", f)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"results": results, "failures": failures}, fh,
                      indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
