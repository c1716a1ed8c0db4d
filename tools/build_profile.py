#!/usr/bin/env python3
"""The main build's loop on the card: its rate, stages, device idle
share and host waits, for one checkout of the port.

    python3 tools/build_profile.py                  # this checkout
    python3 tools/build_profile.py --src DIR/src    # another checkout's
                                                    # repro_torch (unpacked
                                                    # inside this one)

Runs ``chip_smoke.py``'s main build (full-width ColBERTv2 with random
weights from seed 0, 16,384 synthetic docs, encode batch 128, Ward
factor 2, PLAID with ndocs 1024) on one CUDA card:

1. builds the checkout's kernels and warms the build on 256 docs;
2. ``Indexer.build(out_dir=...)``: docs/s by the host clock around the
   whole build, ``stage_seconds`` as the checkout reports them, and
   each payload's sha256 (two checkouts that build the same artifact
   print the same digests);
3. the build loop (``Indexer.encode_and_pool_counted`` over every doc)
   under ``torch.profiler`` (device activities only): wall ms, device
   busy ms, idle share (1 - busy / wall) and the kernels with the most
   device time;
4. the same loop under ``torch.cuda.set_sync_debug_mode("warn")``: the
   calls that made the host wait for the device (a blocking copy, a
   read of a device value), counted by their warning's text.

Prints one JSON object as its last line, with the card's name and power
limit. Compare two checkouts in one call, in turns (parent, change,
change, parent), each in its own process.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import time
import warnings

N_DOCS = 16384
ENCODE_BATCH = 128
NDOCS = 1024
WARM_DOCS = 256
SEED = 0


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _digests(root: str) -> dict:
    from repro_torch.core.persist import read_manifest
    out = {}
    for name, p in sorted(read_manifest(root)["payloads"].items()):
        with open(os.path.join(root, p["file"]), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"),
        help="the src directory whose repro_torch is measured")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("build_profile: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import repro_torch as rt
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    from repro_torch.kernels import build
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    cfg = rt.CONFIG
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "chip-smoke", n_docs=N_DOCS, n_queries=64, n_topics=64,
        doc_len_mean=200, doc_len_std=40, seed=SEED),
        vocab_size=cfg.trunk.vocab_size)
    docs = corpus.doc_token_batch(cfg.doc_maxlen - 2)
    model = rt.init_colbert(cfg, seed=SEED, device=dev)

    def indexer():
        return rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                          pooling_spec=rt.PoolingSpec("ward", 2),
                          encode_batch=ENCODE_BATCH, device=dev)

    indexer().build(docs[:WARM_DOCS])
    torch.cuda.synchronize()
    out_dir = os.path.join(os.path.dirname(src), "build",
                           "build_profile_index")
    t0 = time.perf_counter()
    _, stats = indexer().build(docs, out_dir=out_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    ix = indexer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ix.encode_and_pool_counted(docs)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            ix.encode_and_pool_counted(docs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        plain_loop_ms = (time.perf_counter() - t0) * 1e3
    waits = collections.Counter(str(w.message).split("\n")[0][:90]
                                for w in caught)

    res = dict(
        src=os.path.relpath(src), card=card, kernel_build_s=build_s,
        n_docs=stats.n_docs, build_s=wall, build_docs_s=stats.n_docs / wall,
        stage_seconds=stats.stage_seconds,
        vectors_stored=stats.n_vectors_stored, raw=stats.n_vectors_raw,
        digests=_digests(out_dir), loop_profiled_ms=loop_ms,
        loop_busy_ms=busy, loop_idle_share=1 - busy / loop_ms,
        loop_ms=plain_loop_ms, loop_docs_s=stats.n_docs / plain_loop_ms * 1e3,
        host_waits=sum(waits.values()), host_wait_kinds=dict(waits),
        top_kernels_ms=dict(by_name.most_common(6)))
    print(f"{res['src']}: build {wall:.3f}s ({res['build_docs_s']:.1f} "
          f"docs/s), stages " + ", ".join(
              f"{k} {v:.3f}s" for k, v in stats.stage_seconds.items())
          + f"; loop profiled {loop_ms:.1f} ms, busy {busy:.1f} ms, idle "
          f"share {res['loop_idle_share']:.4f}; loop {plain_loop_ms:.1f} "
          f"ms; host waits {res['host_waits']} [{card}]")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
