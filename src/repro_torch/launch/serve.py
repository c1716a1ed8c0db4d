"""Retrieval serving CLI of the port — closed-loop replay AND
open-loop load (counterpart of ``src/repro/launch/serve.py``).

    # closed-loop (fixed microbatches, service-time percentiles):
    python -m repro_torch.launch.serve --dataset scifact --pool-factor 2 \
        --backend plaid --queries 128 --batch-sizes 1,8,32

    # open-loop (Poisson arrivals through the ServingEngine):
    python -m repro_torch.launch.serve --dataset scifact --pool-factor 2 \
        --backend plaid --queries 256 --arrival-qps 50,200

It runs on the card (``--device cuda``, the default); ``--device cpu``
runs the kernels' plain versions on the CPU. The ColBERTv2 weights are
random from ``--seed``; ``--width full`` takes the full published
widths (12 layers, d 768, proj 128), ``smoke`` (the default, as the
reference's CLI) the small test config.

Closed-loop mode replays fixed-size microbatches through the Searcher
and reports QPS and p50/p99 *service* time per batch size (exactly
``--queries`` queries a row). Open-loop mode (``--arrival-qps``) sends
single queries with exponential inter-arrival gaps to
``launch/engine.py``'s ServingEngine and reports end-to-end p50/p99
(queue wait included) and the batcher's coalescing stats.

``--index-dir`` makes the index an artifact: a manifest there is loaded,
otherwise the built index is saved there; in open-loop mode the engine
watches it and hot-swaps each newly published generation.
``--shard-max-vectors N`` builds through the streaming path. The knob
flags derive from the spec layer (``core/spec.py`` ``add_spec_args``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.api import Retriever
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.persist import (MANIFEST_NAME, artifact_bytes,
                                      artifact_generation)
from repro_torch.core.sharded import ShardedIndex
from repro_torch.core.spec import (IndexSpec, PoolingSpec, RetrieverSpec,
                                   ServeSpec, ShardSpec, add_spec_args,
                                   backend_names, spec_from_args)
from repro_torch.data.corpus import DATASET_SPECS, SyntheticRetrievalCorpus
from repro_torch.device import resolve_device, sync
from repro_torch.launch.engine import ServingEngine, run_open_loop
from repro_torch.models.colbert import init_colbert
from repro_torch.retrieval.searcher import Searcher


def serve_microbatches(searcher: Searcher, q_tokens: np.ndarray,
                       batch_size: int, n_queries: int, k: int = 10):
    """Serve EXACTLY ``n_queries`` in fixed-size microbatches; returns
    (per-batch latencies [s], per-batch served counts).

    The final batch is partial when ``n_queries % batch_size != 0`` —
    earlier versions wrapped around and silently served (and counted)
    extra queries, inflating QPS. Both the full and the remainder batch
    shapes are warmed first so jit compile time never lands in a
    measured batch.
    """
    sizes = [batch_size] * (n_queries // batch_size)
    if n_queries % batch_size:
        sizes.append(n_queries % batch_size)
    searcher.warmup(sorted(set(sizes)), k=k)
    lat = []
    served = 0
    for bs in sizes:
        # modular gather over the query pool; exactly bs queries served
        idx = (served + np.arange(bs)) % len(q_tokens)
        batch = q_tokens[idx]
        t = time.perf_counter()
        searcher.search(batch, k=k)        # returns host arrays: synced
        lat.append(time.perf_counter() - t)
        served += bs
    assert served == n_queries, (served, n_queries)
    return np.array(lat), np.array(sizes)


def _print_probe(index) -> None:
    if isinstance(index, ShardedIndex) and index.last_probe_s:
        per = "  ".join(f"s{i}={t * 1e3:.1f}ms"
                        for i, t in enumerate(index.last_probe_s))
        print(f"      per-shard probe (last batch): {per}")


def closed_loop(searcher, index, q_all, batch_sizes, n_queries, k) -> None:
    print(f"{'batch':>5s} {'served':>7s} {'QPS':>8s} "
          f"{'p50(ms)':>8s} {'p99(ms)':>8s}")
    for bs in batch_sizes:
        lat, sizes = serve_microbatches(searcher, q_all, bs, n_queries, k=k)
        qps = sizes.sum() / lat.sum()
        lat_ms = lat * 1e3
        print(f"{bs:5d} {int(sizes.sum()):7d} {qps:8.1f} "
              f"{np.percentile(lat_ms, 50):8.1f} "
              f"{np.percentile(lat_ms, 99):8.1f}")
        _print_probe(index)


def open_loop(searcher, index, q_all, rates, n_queries,
              serve_spec: ServeSpec, index_dir, index_generation,
              device) -> None:
    print(f"{'offered':>8s} {'achieved':>8s} {'p50(ms)':>8s} "
          f"{'p99(ms)':>8s} {'coalesce':>8s} {'flushes(full/ddl)':>18s} "
          f"{'err':>4s}")
    for i, rate in enumerate(rates):
        engine = ServingEngine.from_spec(
            searcher, serve_spec.replace(warmup_on_start=(i == 0)),
            index_dir=index_dir, index_generation=index_generation,
            device=device)
        with engine:
            row = run_open_loop(engine, q_all, rate, n_queries,
                                k=serve_spec.k)
        snap = engine.stats.snapshot()
        fl = snap["flush_reasons"]
        print(f"{row['arrival_qps']:8.1f} {row['achieved_qps']:8.1f} "
              f"{row['latency_p50_ms']:8.1f} {row['latency_p99_ms']:8.1f} "
              f"{snap['mean_batch_size']:8.1f} "
              f"{fl['full']:8d}/{fl['deadline']:<9d} "
              f"{row['errors']:4d}")
        _print_probe(index)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="scifact",
                    choices=sorted(DATASET_SPECS))
    # typed knobs derive their flags from the spec layer (core/spec.py):
    # --pool-method/--pool-factor (PoolingSpec), --max-batch/
    # --max-wait-ms/--k (ServeSpec), --shard-max-vectors (ShardSpec) —
    # no hand-maintained duplicates of the spec defaults/choices here.
    add_spec_args(ap, PoolingSpec, prefix="pool-",
                  defaults={"factor": 2})
    ap.add_argument("--backend", default="plaid", choices=backend_names())
    ap.add_argument("--queries", type=int, default=128,
                    help="total queries served per batch size / rate")
    ap.add_argument("--batch-sizes", default="1,8,32",
                    help="comma-separated closed-loop microbatch sizes")
    ap.add_argument("--arrival-qps", default=None,
                    help="comma-separated offered loads; selects OPEN-LOOP "
                         "mode (Poisson arrivals through the ServingEngine)")
    add_spec_args(ap, ServeSpec,
                  only=("max_batch", "max_wait_ms", "k", "n_replicas"))
    ap.add_argument("--index-dir", default=None,
                    help="artifact directory: load the index from it if "
                         "a manifest exists (skip corpus encode + build), "
                         "otherwise build and save to it; in open-loop "
                         "mode the engine watches it for hot swaps")
    add_spec_args(ap, ShardSpec)
    ap.add_argument("--device", default="cuda",
                    help="where to serve: cuda (the card) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--width", default="smoke", choices=("smoke", "full"),
                    help="ColBERTv2 widths: the small test config or the "
                         "full published one (random weights either way)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random encoder weights")
    args = ap.parse_args(argv)
    batch_sizes = [int(b) for b in args.batch_sizes.split(",") if b]
    if not batch_sizes or any(b <= 0 for b in batch_sizes):
        ap.error(f"--batch-sizes must be positive ints, got "
                 f"{args.batch_sizes!r}")
    rates = ([float(r) for r in args.arrival_qps.split(",") if r]
             if args.arrival_qps else [])
    if args.arrival_qps and (not rates or any(r <= 0 for r in rates)):
        ap.error(f"--arrival-qps must be positive, got "
                 f"{args.arrival_qps!r}")

    device = resolve_device(args.device)
    cfg = (get_config if args.width == "full"
           else get_smoke_config)("colbertv2")
    serve_spec = spec_from_args(
        ServeSpec, args,
        only=("max_batch", "max_wait_ms", "k", "n_replicas"))
    try:
        spec = RetrieverSpec(
            pooling=spec_from_args(PoolingSpec, args, prefix="pool_"),
            index=IndexSpec.from_config(cfg, backend=args.backend),
            shard=spec_from_args(ShardSpec, args),
            serve=serve_spec)
    except ValueError as e:             # e.g. cascade + sharded
        ap.error(str(e))
    model = init_colbert(cfg, seed=args.seed, device=device)
    corpus = SyntheticRetrievalCorpus(DATASET_SPECS[args.dataset],
                                      vocab_size=cfg.trunk.vocab_size)

    have_artifact = (args.index_dir is not None and os.path.isfile(
        os.path.join(args.index_dir, MANIFEST_NAME)))
    generation = None
    if have_artifact:
        t0 = time.perf_counter()
        # generation read BEFORE the load: a racing publish leaves the
        # label stale-low and the engine watcher swaps once, redundantly
        generation = artifact_generation(args.index_dir)
        retriever = Retriever.load(model, args.index_dir, mmap=True,
                                   serve=serve_spec, device=device)
        index = retriever.index
        sync(device)
        t_load = time.perf_counter() - t0
        kind = (f"{index.n_shards}-shard" if isinstance(index, ShardedIndex)
                else retriever.spec.index.backend)
        print(f"index: loaded {args.index_dir} ({kind}) — "
              f"{index.n_docs} docs, "
              f"{artifact_bytes(args.index_dir) / 2**20:.1f} MiB on disk, "
              f"cold load {t_load * 1e3:.0f}ms (no encoder run)")
    else:
        t0 = time.perf_counter()
        toks = corpus.doc_token_batch(cfg.doc_maxlen - 2)
        retriever = Retriever.build(model, toks, spec,
                                    out_dir=args.index_dir, device=device)
        index, stats = retriever.index, retriever.stats
        sync(device)
        t_build = time.perf_counter() - t0
        shard_note = (f", {stats.n_shards} shards (peak buffer "
                      f"{stats.peak_buffered_vectors} vectors)"
                      if stats.n_shards > 1 else "")
        print(f"index: {stats.n_docs} docs, "
              f"{stats.n_vectors_stored} vectors "
              f"({stats.vector_reduction:.0%} reduction), "
              f"{stats.index_bytes / 2**20:.1f} MiB on disk, "
              f"built in {t_build:.1f}s{shard_note}"
              + (f", saved to {args.index_dir}" if args.index_dir else ""))
        if args.index_dir:                  # our own publish just landed
            generation = artifact_generation(args.index_dir)

    searcher = retriever.searcher
    q_all = corpus.query_token_batch(cfg.query_maxlen - 2)
    if rates:
        open_loop(searcher, index, q_all, rates, args.queries,
                  serve_spec, args.index_dir, generation, device)
    else:
        closed_loop(searcher, index, q_all, batch_sizes, args.queries,
                    serve_spec.k)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
