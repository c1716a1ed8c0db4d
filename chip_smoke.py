#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; no network
    python3 chip_smoke.py --parent DIR   # also build and time the parent
                                         # commit's plaid_probe,
                                         # maxsim_packed, kmeans_assign and
                                         # all-pairs maxsim (their csrc
                                         # unpacked in DIR, inside this
                                         # checkout)

1. Builds the seven CUDA sources from ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, started together).
2. Drives each path through the user entry points, every kernel's launch
   counter set to 0 just before the path and read just after; a path
   fails unless each of its kernels launched, and where it ran
   ``DocStore.gather`` (the f32 rerank reads its candidates in place):
   * main: full-width ColBERTv2 (random weights from a seed), a
     16,384-doc synthetic corpus, ``Indexer.build(out_dir=...)`` with
     Ward pooling at factor 2 on the default PLAID index (K = 256,
     2 bits, nprobe 8, t_cs 0.3) with ``ndocs`` at 1024, PLAID's own
     k = 100 setting, then ``Searcher.search`` on 64 queries in two
     batches of 32 (k = 10). With random weights each document's vectors
     crowd into one or two centroids, so a query's candidate set is ~6-9%
     of the corpus: under the default ndocs = 8192 the approximate-score
     prune — the ``plaid_probe`` kernel — would never run;
   * from_dir: ``Searcher.from_dir`` serves the written artifact; its
     results must equal the in-memory index's exactly;
   * host_probe: the same index with ``probe_kernel="host"``; ids equal
     the device path's tie-aware, scores to 1e-4;
   * dense: a 512-doc plaid index of the corpus's first docs with
     nprobe = K = 256, so every doc is a candidate: the device plan is
     refused and the slate reaches n_docs, so the rerank is the
     all-pairs ``maxsim`` scan;
   * flat: a 4,096-doc flat index (Ward f=2), 64 queries, ``maxsim``;
   * recon_rerank: the 16,384-doc index with ``packed_rerank=False``
     (the ``maxsim_rerank`` kernel reading the candidates from the f32
     reconstruction store in place); results equal the packed path's
     tie-aware, scores to 1e-4;
   * kmeans: a 4,096-doc plaid index pooled by per-document k-means at
     factor 2 (the ``kmeans_assign`` kernel, 11 launches per encode
     batch: 10 Lloyd steps and the final assignment), searched with
     ndocs = 256, PLAID's own k = 10 setting: at 4,096 docs a query's
     candidate set stays under 1024, so only that setting engages the
     prune (``plaid_probe``); each doc stores at most
     n_valid // 2 + 1 vectors;
   * sequential: a 1,024-doc flat index pooled by sequential runs at
     factor 2 (``maxsim``); each doc stores exactly ceil(n_valid / 2);
   * cascade: ``build_cascade`` over 4,096 docs with the reference's
     defaults (Ward, coarse 6, fine 2, 32 candidates), 64 queries
     (``ward_pool``, ``maxsim`` for stage 1, ``maxsim_rerank`` reading
     the fine store in place for stage 2);
   * cascade_from_dir: the cascade saved and served by
     ``Searcher.from_dir``; results equal the in-memory cascade's
     exactly;
   * mutate: the main artifact loaded again by ``Searcher.from_dir``,
     512 of its docs deleted, 1,024 new docs (another corpus seed)
     encoded, Ward-pooled and added, 64 queries: no deleted id comes
     back, the host probe path and the plain versions agree, 16 added
     docs' own vectors find them at top-1, and the index saved
     (compacted) and served again gives equal results;
   * hnsw: ``Indexer.build`` of an hnsw index over 128 docs at Ward f=4
     (the graph built in host Python, timed), 16 docs added and 8
     deleted, 32 queries with ``hnsw_candidates`` 1024 (the slate stays
     under n_docs, so ``maxsim_rerank`` reranks it from the store in
     place; a slate of fewer than k docs pads the results); held to the
     plain versions and to the flat backend's exact MaxSim over the same
     slate, then saved and served again by ``Searcher.from_dir`` with
     equal results;
   * plaid_k8192: a plaid index at K = 8,192 over the flat path's stored
     pooled vectors (``add_flat``), nprobe 32, ndocs 16 (random weights
     leave each query few candidates at this K; these cut every query's
     slate): ``"auto"`` takes the host
     path (``doc_member`` is above the gather cap) and
     ``probe_kernel="device"`` the device path; both prune (the
     ``plaid_probe`` kernel reading its table from device memory) and
     agree with each other and with the plain versions;
   * facade: ``Retriever.load`` of the main artifact (run right after
     from_dir): the spec read back from the manifest equals the main
     path's, and its search the main path's results exactly;
   * stream: the 16,384 docs streamed through ``Retriever.build`` with a
     ``ShardSpec`` (shards of at most 524,288 pooled vectors, ~4; the
     flush pipelined, each shard saved, dropped and reloaded) in encode
     batches of 128, then 64 queries fanned out over the shards on the
     probe pool. A shard holds ~5,000 docs, whose candidate sets stay
     under 1024 at random weights (172-470 a query), so the shards take
     ndocs = 256 (as the kmeans path), where ``plaid_probe`` prunes. The buffer's peak,
     the flush's wait and busy seconds and build docs/s are printed;
     results are held tie-aware to the plain versions, the host probe
     path and ``Retriever.load`` of the artifact (which must give back
     the spec); index search is timed with the probe pool at auto and
     at one thread, on the device and the host candidate paths, with
     each shard's probe seconds;
   * stream_parity: the first 4,096 docs streamed into ~4 shards with
     the flush pipelined and serial: every shard payload's sha256, the
     doc ids and the shard bases must be equal; at exhaustive settings
     (nprobe = K = 256, ndocs 4,096: every shard takes the dense
     fallback through ``maxsim``) the sharded search equals a monolithic
     ``Indexer.build`` with the first shard's codec, ids tie-aware
     within 1e-5, the largest score difference printed;
   * lm: causal-LM serving of Qwen3-0.6B at full width (28 layers,
     d_model 1024, 16 heads over 8 kv heads, d_head 64, vocab 151,936;
     random weights from a seed; bf16 compute; ``use_flash_kernel``)
     through ``make_lm_prefill_step`` (8 prompts of 2,048 token ids,
     cache of 2,048 + 16) and 16 greedy ``make_lm_decode_step`` calls:
     ``flash_attention`` launches exactly 28 times, once a layer, all in
     the prefill. The same weights and prompts then go through the plain
     path (``use_flash_kernel=False``: ``full_attn`` at S = 2,048): the
     last-token logits, each layer's cache after the first and the
     greedy tokens must agree. A second, uncounted run of the kernel path
     keeps the first and last layer's kernel inputs and outputs, which
     are held against the plain version. Then each fault of
     ``LM_FAULTS`` is planted in the model's kernel call (uncounted
     runs): each must break those limits;
   * lm_long: the same model at B = 1, S = 8,192, prefill only (28 more
     launches), held against the plain path, which at this length is
     the chunked online-softmax path; the first and last layer's kernel
     calls are again held against the plain version.
   The dense, flat, kmeans and cascade paths are re-run with the plain
   versions (``impl="ref"``) and must agree.
3. Holds each kernel against its plain PyTorch version at its path's
   shapes (inputs taken from the built indexes and the k-means path's
   first encode batch; ``ward_pool`` also at N = 512, where its triangle
   lives in device memory, timed there too, and on exact duplicate tokens
   at factors 2, 3, 4 and 6, where it must be equal or tie-equivalent;
   ``plaid_probe`` and ``maxsim_packed`` also at Lq = 300,
   three launches of at most 128 query tokens (``plaid_probe`` also at
   K = 2,048 / Lq = 32, K = 512 / Lq = 128 and 300, K = 16,384 / Lq = 32,
   timed there, at the plaid_k8192 path's own inputs, and both of its
   routes timed against each other at four (K, Lq) where both serve), at
   the main path's own
   inputs (the arguments of one search batch's two calls, captured), on
   uniformly random codes (``plaid_probe``: the index's crowded codes
   take its distinct-code lookups, uniform ones the full read) and at
   b = 4 (``maxsim_packed``, whose SASS must
   hold HMMA instructions: its products run on the tensor cores);
   ``flash_attention`` on
   seeded random inputs in the Qwen3, Qwen1.5 and Qwen2.5-14B head
   layouts, bf16 and f32, Sq < Skv, Sq > Skv, non-causal, the lm_long
   shape, ragged Sq and Skv at dh 128, and the timed lm shape), and
   times both with CUDA events (behind a sleep kernel, so that host
   dispatch is not counted where the call does not wait on the card);
   prints each kernel's bound (bytes over 3.35 TB/s or operations over
   the f32 peak of 67 TFLOP/s — for ``flash_attention`` the bf16
   tensor-core peak of 989 TFLOP/s, for the products of
   ``maxsim_packed``, ``maxsim`` and ``kmeans_assign`` three passes at
   the TF32 peak of 494.7 TFLOP/s, the f32 bound printed beside — the
   larger). ``maxsim`` is also held and timed at the flat path's own
   inputs (one search batch's arguments, captured) and ``kmeans_assign``
   on random unit vectors at its path's shape; both are timed beside
   ``torch.matmul`` of their product alone (f32, TF32 off; for reference
   only: no port, no library_ms) and their SASS must hold HMMA.
   ``maxsim_rerank`` is held and timed from gathered candidates (one
   slab of the recon store) and read in place at the recon_rerank
   path's own slate and the cascade's stage 2 (both captured from one
   batch); ``dequant_score`` on the main index's candidate rows (its
   SASS must hold HMMA too). With ``--parent``, the earlier checkout's
   C entries (checked against ``PARENT_ABI``) are built, held to the
   same limits and timed on the same inputs: its ``plaid_probe``,
   ``maxsim_packed``, ``kmeans_assign`` and all-pairs ``maxsim`` must
   give this checkout's results bit for bit; its rerank is timed at the
   slates with the gather it needs. One main-path
   ``search_encoded`` batch is traced with ``torch.profiler`` and split
   by its ``search.*`` ranges (centroid scores, ``probe_members`` and
   compaction, the code gather, ``plaid_probe``, the ``stable_topk``
   prune, the packed gather, ``maxsim_packed``, the top-k), with the
   device's idle share over the batch, and so is one recon_rerank batch
   (the same candidate stages, then ``search.maxsim_rerank``).
   ``flash_attention`` is also timed against
   ``scaled_dot_product_attention`` (its
   ``library_ms``; the port never calls it), with its achieved TFLOP/s,
   and its SASS is read with ``cuobjdump -sass``: it fails unless the
   tool is there and the bf16 body issues HMMA (tensor-core)
   instructions.
4. Re-runs the main search with the plain versions (``impl="ref"``): the
   ids must agree tie-aware and the scores to 1e-4.

The line before the last holds ``nvidia-smi``'s card name and power
limit; the one before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing that line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_OPS_PER_S = 67e12              # H100 SXM f32, outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 494.7e12          # H100 SXM TF32 tensor cores, dense
TF32_PASSES = 3                    # 3xTF32: hi*hi + hi*lo + lo*hi
N_DOCS = 16384
N_QUERIES = 64
QUERY_BATCH = 32
QUERY_LEN = 32                     # ColBERTv2 query_maxlen
TOP_K = 10
NDOCS = 1024                       # PLAID's k=100 setting: engages the prune
SEED = 0
SLEEP_CYCLES = 100_000_000         # ~50 ms: longer than the host queues
SCORE_ATOL = 1e-4                  # f32 sums in another order
DENSE_DOCS = 512
FLAT_DOCS = 4096
KMEANS_DOCS = 4096
KMEANS_NDOCS = 256                 # PLAID's k=10 setting (see the docstring)
SEQUENTIAL_DOCS = 1024
CASCADE_DOCS = 4096
ENCODE_BATCH = 128
MUTATE_DELETE = 512                # main-index docs deleted on the mutate path
MUTATE_ADD = 1024                  # new docs added there (another corpus seed)
MUTATE_SELF = 16                   # added docs queried by their own vectors
HNSW_DOCS = 128                    # the graph is built in host Python
HNSW_FACTOR = 4
# token hits a query (the reference's default): random weights make a
# query's tokens nearly alike (the path prints their mean cosine), so the
# hits crowd into a few docs and the slate stays under n_docs
HNSW_CANDIDATES = 1024
HNSW_ADD = 16
HNSW_DELETE = 8
STREAM_SHARD_MAX = 524_288         # pooled vectors a shard (~4 shards)
STREAM_NDOCS = 256                 # a ~5,000-doc shard's prune (see stream)
PARITY_DOCS = 4096
PARITY_SHARD_MAX = 131_072         # ~4 shards of the first 4,096 docs
PARITY_ATOL = 1e-5
K8192 = 8192                       # ColBERT's K rule at ~3.6e5 vectors
# random weights make a query's tokens nearly alike: at K = 8,192 and
# nprobe 8 a query probes few centroids in all and keeps a few candidates
# (the path prints how many); at nprobe 32 every query keeps more than
# ndocs 16, so the prune cuts every slate
K8192_NPROBE = 32
K8192_NDOCS = 16
NEAR_TIE = 1e-5                    # kmeans_assign: top-two sims this close
LONG_LQ = 300                      # a query above the kernels' 128 a launch
LM_ARCH = "qwen3-0.6b"
LM_BATCH = 8
LM_PROMPT = 2048
LM_DECODE = 16
LM_LONG = 8192
# kernel path vs plain path, both bf16 through 28 layers: the attention
# outputs differ by about one bf16 step per layer (the kernel rounds the
# unnormalized p, the plain path the normalized weights), which grows to
# ~2% relative through the depth (measured on the CPU with the plain
# version at 28 layers and d_model 256 / 512: logits 2.1%, cache 1.6%).
# The cache is held layer by layer from the second layer on: layer 0's
# k and v are computed before any attention and do not depend on it.
LM_LOGITS_ATOL = 0.25              # logits: max abs
LM_REL = 0.05                      # logits, each layer's cache: |a-b|/|b|
# faults planted in the kernel path's attention (a wrapper in place of the
# model's kernel call, outside every counted run); each must break one of
# the limits above, else those limits could not see a wrong kernel
LM_FAULTS = ("causal=False", "kv head h % KV, not h // G",
             "diagonal off by one")
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}     # atol = rtol
FLASH_CASES = [  # (what, B, H, KV, Sq, Skv, dh, causal, dtype)
    ("qwen3 16/8/64", 1, 16, 8, 4096, 4096, 64, True, "bfloat16"),
    ("qwen1.5 16/16/64", 1, 16, 16, 4096, 4096, 64, True, "bfloat16"),
    ("qwen2.5-14b 40/8/128", 1, 40, 8, 4096, 4096, 128, True, "bfloat16"),
    ("qwen3 16/8/64 f32", 1, 16, 8, 4096, 4096, 64, True, "float32"),
    ("Sq < Skv", 1, 16, 8, 1000, 4096, 64, True, "bfloat16"),
    ("Sq > Skv", 1, 16, 8, 4096, 1000, 64, True, "bfloat16"),
    ("non-causal", 1, 16, 8, 4096, 4096, 64, False, "bfloat16"),
    ("lm_long 16/8/64", 1, 16, 8, 8192, 8192, 64, True, "bfloat16"),
    ("ragged 40/8/128", 1, 40, 8, 1000, 1333, 128, True, "bfloat16"),
]
ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT_DIR = os.path.join(ROOT, "build", "chip_smoke_index")
CASCADE_DIR = os.path.join(ROOT, "build", "chip_smoke_cascade")
MUTATE_DIR = os.path.join(ROOT, "build", "chip_smoke_mutate")
HNSW_DIR = os.path.join(ROOT, "build", "chip_smoke_hnsw")
STREAM_DIR = os.path.join(ROOT, "build", "chip_smoke_stream")
PARITY_DIR = os.path.join(ROOT, "build", "chip_smoke_parity")
# kernels each path must launch
PATH_KERNELS = {
    "main": ("ward_pool", "plaid_probe", "maxsim_packed"),
    "from_dir": ("plaid_probe", "maxsim_packed"),
    "host_probe": ("plaid_probe", "maxsim_packed"),
    "dense": ("ward_pool", "maxsim"),
    "flat": ("ward_pool", "maxsim"),
    "recon_rerank": ("plaid_probe", "maxsim_rerank"),
    "kmeans": ("kmeans_assign", "plaid_probe", "maxsim_packed"),
    "sequential": ("maxsim",),
    "cascade": ("ward_pool", "maxsim", "maxsim_rerank"),
    "cascade_from_dir": ("maxsim", "maxsim_rerank"),
    "mutate": ("plaid_probe", "maxsim_packed"),
    "hnsw": ("ward_pool", "maxsim_rerank"),
    "plaid_k8192": ("plaid_probe", "maxsim_packed"),
    "facade": ("plaid_probe", "maxsim_packed"),
    "stream": ("ward_pool", "plaid_probe", "maxsim_packed"),
    "stream_parity": ("ward_pool", "maxsim"),
    "lm": ("flash_attention",),
    "lm_long": ("flash_attention",),
}
PATH_LAUNCHES = {}
MAIN_NUMBERS = {}                  # the main path's build and search times
FLASH_ERRS = []                    # flash_attention vs plain, every check
NO_LIBRARY = ("null: no single PyTorch call does the masked max over doc "
              "tokens and the masked sum over query tokens")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    """Mean ms per call on the card: CUDA events around ``reps`` calls
    after one warm-up call. A sleep kernel queued before the first event
    holds the card while the host queues the calls, so a call that does
    not wait on the card is timed by its device work, not by the host's
    dispatch (which varies across machines several-fold); a call that
    does wait is timed as before."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(n_bytes: float, n_ops: float,
              ops_per_s: float = F32_OPS_PER_S, more=()):
    """The larger of the bytes over the HBM rate and the operations over
    their peak rate; ``more``: further (operations, rate) pairs of other
    types, whose times add to the first."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / ops_per_s + sum(o / r for o, r in more)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_path(name, torch, fn):
    """Drive one path with every launch counter at 0 just before it and
    read just after; fails unless each of the path's kernels launched,
    and where a ``DocStore.gather`` ran (the f32 rerank reads its
    candidates from the store in place)."""
    from repro_torch.core.docstore import DocStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gathers = []
    gather = DocStore.gather

    def counted(self, cand):
        gathers.append(tuple(cand.shape))
        return gather(self, cand)

    DocStore.gather = counted
    try:
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
    finally:
        DocStore.gather = gather
    launches = launch_counts()
    PATH_LAUNCHES[name] = launches
    print(f"{name} path launches: {launches}")
    missing = [k for k in PATH_KERNELS[name] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {name} path: "
                             f"{missing}")
    if gathers:
        raise AssertionError(f"the {name} path ran DocStore.gather "
                             f"{len(gathers)} times: {gathers}")
    return out


def _search_all(searcher, queries, **kw):
    res = [searcher.search(queries[lo:lo + QUERY_BATCH], k=TOP_K, **kw)
           for lo in range(0, len(queries), QUERY_BATCH)]
    return (np.concatenate([r[0] for r in res]),
            np.concatenate([r[1] for r in res]))


def _agree(what, S, I, S1, I1):
    """Ids equal tie-aware and scores to rtol 1e-5 / atol 1e-4."""
    from repro_torch.core.maxsim import tie_aware_mismatches
    bad = tie_aware_mismatches(I, S, I1, S1, SCORE_ATOL)
    fin = np.isfinite(S) & np.isfinite(S1)      # -inf pads: a short slate
    diff = float(np.abs(S[fin] - S1[fin]).max(initial=0.0))
    print(f"{what}: ids equal {float((I == I1).mean()):.4f}, tie-aware "
          f"mismatches {bad}, max score diff {diff:.3g}")
    if bad or not np.allclose(S, S1, rtol=1e-5, atol=SCORE_ATOL):
        raise AssertionError(f"{what}: results disagree")


def _check_results(S, I, n_docs):
    if S.shape != (N_QUERIES, TOP_K) or I.shape != (N_QUERIES, TOP_K):
        raise AssertionError(f"result shapes {S.shape} {I.shape}")
    if not np.isfinite(S).all():
        raise AssertionError("non-finite scores in the results")
    if not ((I >= 0) & (I < n_docs)).all():
        raise AssertionError("invalid doc ids in the results")


def _steady_search_s(torch, searcher, qv):
    """Seconds of one warm pass of index search over encoded queries."""
    for _ in range(2):
        t0 = time.perf_counter()
        for lo in range(0, len(qv), QUERY_BATCH):
            searcher.search_encoded(qv[lo:lo + QUERY_BATCH], k=TOP_K)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main_path(rt, torch, dev):
    """Build (writing the artifact) and search through the entry points;
    returns what the other paths and the checks need."""
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus

    cfg = rt.CONFIG
    t0 = time.perf_counter()
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "chip-smoke", n_docs=N_DOCS, n_queries=N_QUERIES, n_topics=64,
        doc_len_mean=200, doc_len_std=40, seed=SEED),
        vocab_size=cfg.trunk.vocab_size)
    docs = corpus.doc_token_batch(cfg.doc_maxlen - 2)
    queries = corpus.query_token_batch(cfg.query_maxlen - 2)
    model = rt.init_colbert(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"setup: corpus {docs.shape} + full-width ColBERTv2 "
          f"({sum(p.numel() for p in model.parameters())} params) in "
          f"{time.perf_counter() - t0:.3f}s")

    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)

    def drive():
        t0 = time.perf_counter()
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=128, device=dev)
        index, stats = indexer.build(docs, out_dir=ARTIFACT_DIR)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        t0 = time.perf_counter()
        S, I = _search_all(searcher, queries)
        torch.cuda.synchronize()
        return index, stats, build_s, searcher, S, I, time.perf_counter() - t0

    index, stats, build_s, searcher, S, I, search_s = run_path(
        "main", torch, drive)
    _candidate_report(torch, index, searcher.encode_queries(queries))
    print(f"build: {stats.n_docs} docs in {build_s:.3f}s "
          f"({stats.n_docs / build_s:.1f} docs/s); stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in stats.stage_seconds.items()))
    print(f"vectors: raw {stats.n_vectors_raw}, stored "
          f"{stats.n_vectors_stored} (reduction "
          f"{stats.vector_reduction:.4f}); device bytes {stats.device_bytes}")
    if stats.n_vectors_stored > stats.n_vectors_raw / 2 + stats.n_docs:
        raise AssertionError("Ward f=2 stored more than raw/2 + n_docs")
    _check_results(S, I, stats.n_docs)

    # steady state: the same two batches again, stage by stage
    t_enc = t_search = 0.0
    for lo in range(0, N_QUERIES, QUERY_BATCH):
        t0 = time.perf_counter()
        qv = searcher.encode_queries(queries[lo:lo + QUERY_BATCH])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        searcher.search_encoded(qv, k=TOP_K)
        torch.cuda.synchronize()
        t_enc += t1 - t0
        t_search += time.perf_counter() - t1
    print(f"search: {N_QUERIES} queries first pass {search_s:.3f}s; steady "
          f"{N_QUERIES / (t_enc + t_search):.1f} QPS (encode {t_enc:.4f}s, "
          f"index search {t_search:.4f}s)")
    MAIN_NUMBERS.update(build_docs_s=stats.n_docs / build_s,
                        index_search_s=t_search)
    return index, stats, model, docs, searcher, queries, S, I


def _candidate_report(torch, index, qv):
    """Per-query candidate counts of stage 2 (the prune engages when a
    batch's largest count pads past ``ndocs``), printed and returned."""
    from repro_torch.core.plaid import _centroid_scores_batch, probe_members
    p = index._plaid
    div = p.device_ivf()
    cs = _centroid_scores_batch(qv, p.codec.centroids)
    qm = torch.ones(qv.shape[:2], dtype=torch.bool, device=qv.device)
    live = torch.ones(p.n_docs, dtype=torch.bool, device=qv.device)
    member, counts = probe_members(cs, qm, div.doc_member, live,
                                   min(index.nprobe, p.codec.n_centroids))
    c = counts.float()
    owners = div.doc_member.sum(dim=1)
    print(f"candidates per query: min {int(c.min())} median "
          f"{float(c.median()):.0f} max {int(c.max())} of {p.n_docs} docs "
          f"(ndocs {index.ndocs}); docs per centroid: median "
          f"{float(owners.median()):.0f} max {int(owners.max())}")
    return counts


def _ward_inputs(torch, dev, B, N, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, N, d), generator=g, device=dev)
    n_valid = torch.randint(N // 2, N + 1, (B,), generator=g, device=dev)
    mask = torch.arange(N, device=dev)[None, :] < n_valid[:, None]
    return x, mask


def check_ward(torch, dev):
    """At the build's shape (B = 64, N = 256, d = 128) and at N = 512 (a
    doc_maxlen of 512: above 330 tokens the kernel keeps the distance
    triangle in device memory), assignments equal the plain version's in
    every document; on exact duplicate tokens (ties) at factors 2, 3, 4,
    6 they are equal or tie-equivalent (``ward_agree``: as many clusters,
    Ward objectives within 1e-5; the kernel's duplicates are exactly 0
    apart, the plain version's nearly so). Timed at both N."""
    from repro_torch.core.ward import ward_targets
    from repro_torch.kernels.ward_pool.ops import ward_assign
    from repro_torch.kernels.ward_pool.ref import ward_agree
    B, N, d, f = 64, 256, 128, 2
    x, mask = _ward_inputs(torch, dev, B, N, d, SEED)
    x512, mask512 = _ward_inputs(torch, dev, B, 512, d, SEED + 1)
    checked = []
    for what, xs, ms, fs in [("build shape", x, mask, f),
                             ("N=512", x512, mask512, f)] + [
            (f"duplicates f={t}", *_ward_ties(torch, dev, N, d, t), t)
            for t in (2, 3, 4, 6)]:
        got = ward_assign(xs, ms, fs)
        want = ward_assign(xs, ms, fs, impl="ref")
        torch.cuda.synchronize()
        equal = int((got == want).all(dim=1).sum())
        ties = what.startswith("duplicates")
        bad = int((~ward_agree(xs, ms, got, want)).sum()) if ties else (
            xs.shape[0] - equal)
        n = xs.shape[1]
        print(f"ward_pool {what} (B={xs.shape[0]}, N={n}): {equal} docs "
              f"equal to the plain version, {bad} "
              f"{'not tie-equivalent' if ties else 'differ'}")
        if bad:
            raise AssertionError(f"ward_pool {what}: {bad} docs disagree "
                                 f"with the plain version")
        checked.append(f"{what} (B={xs.shape[0]}, N={n}): {equal} equal"
                       + (", the rest tie-equivalent" if ties else ""))
    _, steps = ward_targets(mask, f)
    n_steps = int(steps.sum())
    P = N * (N - 1) // 2
    # the distances (upper triangle and norms, 2 d each) and, per merge,
    # an O(N) argmin and Lance-Williams row update (~12 operations a token)
    ops = B * (P + N) * d * 2 + n_steps * 12 * N
    bound, by = _bound_ms(_nbytes(x, mask) + B * N * 4, ops)
    ms512 = _time_ms(lambda: ward_assign(x512, mask512, f))
    print(f"ward_pool at B={B}, N=512, d={d}: {ms512:.4f} ms")
    return dict(name="ward_pool", route="cuda",
                source="src/repro_torch/csrc/ward_pool.cu",
                replaces="src/repro/kernels/ward_pool/kernel.py:63",
                **_launches("ward_pool"), max_abs_err=0.0,
                ms=_time_ms(lambda: ward_assign(x, mask, f)),
                plain_ms=_time_ms(lambda: ward_assign(x, mask, f, impl="ref"),
                                  reps=1),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"{'; '.join(checked)}; timed at B={B}, N={N}, d={d}, "
                      f"f={f}; at N=512 {ms512:.4f} ms")


def _ward_ties(torch, dev, N, d, factor):
    """Docs whose tokens are each repeated ``factor`` times, shuffled (exact
    duplicates: zero-distance ties); one half-padded doc, one all-pad."""
    g = torch.Generator(device=dev).manual_seed(SEED + factor)
    B, n = 8, N // factor
    base = torch.randn((B, n, d), generator=g, device=dev)
    x = base.repeat(1, factor, 1)[:, torch.randperm(n * factor, generator=g,
                                                    device=dev)]
    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
    mask[1, n * factor // 2:] = False
    mask[2] = False
    return x, mask


def _hold(what, torch, got, want, err_list):
    """-inf slots equal and finite values to rtol 1e-5 / atol SCORE_ATOL;
    appends the max abs error of the finite values."""
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    err_list.append(err)
    if not (torch.equal(torch.isinf(got), torch.isinf(want)) and
            torch.allclose(got[fin], want[fin], rtol=1e-5, atol=SCORE_ATOL)):
        raise AssertionError(f"{what}: disagrees with the plain version "
                             f"(max abs err {err})")
    return err


def _probe_bound(q, qm, cen, codes, cmask, vmask):
    """Bytes: the query, centroids and slot flags, the codes and masks of
    the valid slots only, the scores; operations: the [Lq, K] table a
    query and a lookup and a max per valid token and query token."""
    Nq, Lq, dim = q.shape
    K = cen.shape[0]
    L = codes.shape[2]
    n_valid = int(vmask.sum())
    n_bytes = (_nbytes(q, qm, cen, vmask) + n_valid * L * 5
               + vmask.numel() * 4)
    ops = Nq * Lq * K * dim * 2 + int(cmask.sum()) * Lq * 2
    return _bound_ms(n_bytes, ops)


def _crowded_share(codes, cmask, vmask):
    """Share of the valid slots on which ``plaid_probe`` takes its
    distinct-code lookups: the first 32 tokens repeat their first code
    (a masked token counting as one more code) in more than a quarter of
    places."""
    n = min(32, codes.shape[2])
    first = codes[..., :n].masked_fill(~cmask[..., :n], -1)
    crowded = 4 * (first == first[..., :1]).sum(-1) > n
    return float(crowded[vmask].float().mean())


def check_plaid_probe(torch, dev, index, qv, path_args, k8192_args, parent):
    """At the synthetic shape (each query scores every doc of the corpus,
    9 in 10 slots valid, the index's own codes), on uniformly random codes
    at that shape, at the main path's own inputs (``path_args``), at the
    plaid_k8192 path's (``k8192_args``: K = 8,192, the table in device
    memory) and at Lq = 300; timed beside the parent design where
    ``parent`` holds it."""
    from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores
    p = index._plaid
    codes, tok_mask = p.padded_codes()
    Nq, Lq, _ = qv.shape
    C = p.n_docs
    t_cs = index.t_cs
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cand = torch.stack([torch.randperm(C, generator=g, device=dev)
                        for _ in range(Nq)])
    cmask = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False                       # masked query tokens too
    gcodes = codes[cand]
    gmask = tok_mask[cand] & cmask[:, :, None]
    cen = p.codec.centroids.contiguous()
    K, dim = cen.shape
    L = gcodes.shape[2]
    ucodes = torch.randint(0, K, gcodes.shape, generator=g, device=dev,
                           dtype=torch.int32)
    cases = {"synthetic": (qv, qm, cen, gcodes, gmask, cmask),
             "uniform": (qv, qm, cen, ucodes, gmask, cmask),
             "path": path_args, "k8192 path": k8192_args}
    errs = []

    def run(args, impl="auto"):
        return plaid_probe_scores(*args, t_cs=t_cs, impl=impl)

    times = {}
    for what, args in cases.items():
        _hold(f"plaid_probe {what}", torch, run(args), run(args, "ref"), errs)
        times[what] = _time_ms(lambda: run(args))
        if parent and what != "k8192 path":     # past the parent's K
            got = parent["plaid_probe"](*args, t_cs)
            if not torch.equal(got, run(args)):
                raise AssertionError(f"plaid_probe {what}: differs from the "
                                     f"parent design's scores")
            times[what + " parent"] = _time_ms(
                lambda: parent["plaid_probe"](*args, t_cs))
    # a long query (Lq = 300): three launches of at most 128 tokens, summed
    q_long, qm_long = _long_queries(torch, dev, Nq, qv.shape[2], SEED + 5)
    long_args = (q_long, qm_long, cen, gcodes, gmask, cmask)
    long_err = _hold(f"plaid_probe at Lq={LONG_LQ}", torch, run(long_args),
                     run(long_args, "ref"), errs)
    print(f"plaid_probe at Lq={LONG_LQ}: max abs err {long_err:.3g}")
    large = _probe_large_k(torch, dev, dim, t_cs, errs)
    plain_ms = _time_ms(lambda: run(cases["synthetic"], "ref"), reps=2)
    path_plain_ms = _time_ms(lambda: run(path_args, "ref"), reps=2)
    bound, by = _probe_bound(*cases["synthetic"])
    path_bound, path_by = _probe_bound(*path_args)
    pc, pm, pv = path_args[3:]
    print(f"plaid_probe path inputs: Nq={pc.shape[0]} x C={pc.shape[1]} "
          f"slots, {int(pv.sum())} valid, L={pc.shape[2]}; bound "
          f"{path_bound:.4f} ms ({path_by}), plain {path_plain_ms:.4f} ms")
    k8192_plain_ms = _time_ms(lambda: run(k8192_args, "ref"), reps=2)
    k8192_bound, k8192_by = _probe_bound(*k8192_args)
    kc, km, kv = k8192_args[3:]
    print(f"plaid_probe k8192 path inputs: K={k8192_args[2].shape[0]}, "
          f"Nq={kc.shape[0]} x C={kc.shape[1]} slots, {int(kv.sum())} "
          f"valid, L={kc.shape[2]}; {times['k8192 path']:.4f} ms, bound "
          f"{k8192_bound:.4f} ms ({k8192_by}), plain {k8192_plain_ms:.4f} ms")
    print("plaid_probe times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    print("plaid_probe share of valid slots taking the distinct-code "
          "lookups: " + ", ".join(f"{k} {_crowded_share(*a[3:]):.4f}"
                                  for k, a in cases.items()))
    return dict(name="plaid_probe", route="cuda",
                source="src/repro_torch/csrc/plaid_probe.cu",
                replaces="src/repro/kernels/plaid_probe/kernel.py:62",
                **_launches("plaid_probe"), max_abs_err=max(errs),
                ms=times["synthetic"], plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, path_ms=times["path"],
                path_plain_ms=path_plain_ms, path_bound_ms=path_bound,
                parent_ms=times.get("synthetic parent"),
                parent_path_ms=times.get("path parent"), times_ms=times,
                k8192_path_ms=times["k8192 path"],
                k8192_path_plain_ms=k8192_plain_ms,
                k8192_path_bound_ms=k8192_bound, **large,
                check=f"-inf slots equal, finite allclose rtol 1e-5 atol "
                      f"{SCORE_ATOL} (synthetic Nq={Nq}, Lq={Lq}, C={C}, "
                      f"L={L}, K={K}; uniformly random codes; the main "
                      f"and plaid_k8192 paths' own inputs"
                      f"{'; equal to the parent design' if parent else ''};"
                      f" and at Lq={LONG_LQ}, three launches of two "
                      f"kernels; at K = 2,048 / Lq = 32, K = 512 / Lq = 128 "
                      f"and {LONG_LQ}, K = 16,384 / Lq = 32, and both routes "
                      f"where both serve); bound: valid slots' bytes, f32 "
                      f"rate")


# (K, Lq) cases of plaid_probe past the main path's K = 256, where the
# table of 128 query tokens a launch outgrows shared memory
PROBE_LARGE_K = ((2048, 32), (512, 128), (512, LONG_LQ), (16384, 32))
# (K, Lq, chunk) where both routes serve, timed against each other: the
# table in shared memory at the widest query chunk it fits, or in device
# memory at 128 query tokens a launch
PROBE_ROUTES_AT = ((256, 32, 128), (512, 128, 96), (700, 128, 64),
                   (1024, 128, 32))
PROBE_LARGE_C = 4096


def _probe_large_k(torch, dev, dim, t_cs, errs):
    """``plaid_probe`` on random unit centroids and uniformly random codes
    (Nq = 32, C = 4,096 slots, 90% valid, L = 129) at each of
    ``PROBE_LARGE_K``, held to the plain version; the K = 16,384 case
    timed with its bound; at each of ``PROBE_ROUTES_AT`` both routes held
    and timed. -> the kernels-line keys."""
    from repro_torch.kernels.plaid_probe.ops import (_load, plaid_probe_scores,
                                                     probe_route)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    Nq, C, L = 32, PROBE_LARGE_C, 129
    cmask = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    tmask = (torch.rand((Nq, C, L), generator=g, device=dev) < 0.8) & \
        cmask[:, :, None]

    def inputs(K, Lq):
        q = torch.randn((Nq, Lq, dim), generator=g, device=dev)
        cen = torch.randn((K, dim), generator=g, device=dev)
        codes = torch.randint(0, K, (Nq, C, L), generator=g, device=dev,
                              dtype=torch.int32)
        qm = torch.rand((Nq, Lq), generator=g, device=dev) > 0.05
        return (q / q.norm(dim=-1, keepdim=True), qm,
                cen / cen.norm(dim=-1, keepdim=True), codes, tmask, cmask)

    smem = _load().plaid_probe_smem_bytes
    out = {}
    for K, Lq in PROBE_LARGE_K:
        args = inputs(K, Lq)
        route = probe_route(Lq, K, dim, smem)
        err = _hold(f"plaid_probe K={K} Lq={Lq} route {route}", torch,
                    plaid_probe_scores(*args, t_cs=t_cs),
                    plaid_probe_scores(*args, t_cs=t_cs, impl="ref"), errs)
        print(f"plaid_probe K={K}, Lq={Lq}: route {route}, max abs err "
              f"{err:.3g}")
        if K == 16384:
            ms = _time_ms(lambda: plaid_probe_scores(*args, t_cs=t_cs))
            plain = _time_ms(lambda: plaid_probe_scores(*args, t_cs=t_cs,
                                                        impl="ref"), reps=2)
            bound, by = _probe_bound(*args)
            out.update(k16384_ms=ms, k16384_plain_ms=plain,
                       k16384_bound_ms=bound, k16384_bound_by=by)
            print(f"plaid_probe K=16384, Lq=32 (Nq={Nq}, C={C}, L={L}): "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({by})")
    route_ms = {}
    for K, Lq, width in PROBE_ROUTES_AT:
        args = inputs(K, Lq)
        want = plaid_probe_scores(*args, t_cs=t_cs, impl="ref")
        times = {}
        for route, chunk in (("smem", width), ("global", 128)):
            _hold(f"plaid_probe K={K} Lq={Lq} route {route}", torch,
                  plaid_probe_scores(*args, t_cs=t_cs, route=route,
                                     chunk=chunk), want, errs)
            times[f"{route} {chunk}"] = _time_ms(
                lambda: plaid_probe_scores(*args, t_cs=t_cs, route=route,
                                           chunk=chunk))
        bound, by = _probe_bound(*args)
        route_ms[f"K={K} Lq={Lq}"] = dict(times, bound=bound)
        print(f"plaid_probe K={K}, Lq={Lq} (Nq={Nq}, C={C}, L={L}): the "
              f"rule takes {probe_route(Lq, K, dim, smem)}; " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; bound {bound:.4f} ms ({by})")
    out.update(route_ms=route_ms)
    return out


def _packed_bound(q, qm, w, a, dm, cen, vals):
    """Bytes: the query, the token masks, the words and ids of the valid
    tokens only, the codec, the scores; operations: per valid query and
    doc token 2 dim at 3xTF32 (three passes at the TF32 tensor-core
    rate), and the reconstruction's 4 dim per valid doc token at f32."""
    Nq, Lq, dim = q.shape
    W = w.shape[-1]
    n_tok = int(dm.sum())
    pairs = int((qm.sum(1) * dm.flatten(1).sum(1)).sum())
    n_bytes = (_nbytes(q, qm, dm, cen, vals) + n_tok * (4 * W + 4)
               + dm.shape[0] * dm.shape[1] * 4)
    return _bound_ms(n_bytes, n_tok * dim * 4, F32_OPS_PER_S,
                     more=[(pairs * dim * 2 * TF32_PASSES, TF32_OPS_PER_S)])


def check_maxsim_packed(torch, dev, index, qv, path_args, parent):
    """At the synthetic shape (S = 1,024 random docs of the index a query,
    19 in 20 valid) at b = 2 (the index's codes) and b = 4 (random
    codes), at the main path's own inputs (``path_args``) and at
    Lq = 300; timed beside the parent design where ``parent`` holds it.
    Fails unless the built library issues HMMA (tensor-core) instructions."""
    from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
    p = index._plaid
    ids, words, tmask = p.padded_packed()
    Nq, Lq, dim = qv.shape
    S = 1024
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    cand = torch.randint(0, p.n_docs, (Nq, S), generator=g, device=dev)
    cm = torch.rand((Nq, S), generator=g, device=dev) < 0.95
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    cases, errs, times = {}, [], {}
    for bits in (2, 4):
        if bits == p.codec.bits:
            w, cen, vals = words[cand], p.codec.centroids, p.codec.values
        else:                                # random codes of the other width
            W = dim * bits // 32
            w = torch.randint(-2 ** 31, 2 ** 31 - 1, (Nq, S, ids.shape[1], W),
                              generator=g, device=dev, dtype=torch.int32)
            cen = p.codec.centroids
            vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.05
        cases[f"b={bits}"] = ((qv, qm, w, ids[cand], tmask[cand] & cm[:, :, None],
                               cen.contiguous(), vals.contiguous()), bits)
    cases["path"] = (path_args, p.codec.bits)

    def run(args, bits, impl="auto"):
        return maxsim_packed_rerank(*args, bits=bits, impl=impl)

    for what, (args, bits) in cases.items():
        _hold(f"maxsim_packed {what}", torch, run(args, bits),
              run(args, bits, "ref"), errs)
        times[what] = _time_ms(lambda: run(args, bits))
        if parent:
            got = parent["maxsim_packed"](*args, bits)
            if not torch.equal(got, run(args, bits)):
                raise AssertionError(f"maxsim_packed {what}: differs from "
                                     f"the parent design's scores")
            times[what + " parent"] = _time_ms(
                lambda: parent["maxsim_packed"](*args, bits))
    # a long query (Lq = 300): three launches of at most 128 tokens, summed
    q_long, qm_long = _long_queries(torch, dev, Nq, dim, SEED + 6)
    c_long = cand[:, :256]            # the plain version holds [.., Lq, Ld]
    long_args = (q_long, qm_long, words[c_long], ids[c_long],
                 tmask[c_long] & cm[:, :256, None],
                 p.codec.centroids.contiguous(), p.codec.values.contiguous())
    long_err = _hold(f"maxsim_packed at Lq={LONG_LQ}", torch,
                     run(long_args, p.codec.bits),
                     run(long_args, p.codec.bits, "ref"), errs)
    print(f"maxsim_packed at Lq={LONG_LQ}: max abs err {long_err:.3g}")
    syn, bits = cases[f"b={p.codec.bits}"]
    plain_ms = _time_ms(lambda: run(syn, bits, "ref"), reps=2)
    path_plain_ms = _time_ms(lambda: run(path_args, bits, "ref"), reps=2)
    bound, by = _packed_bound(*syn)
    path_bound, path_by = _packed_bound(*path_args)
    pdm = path_args[4]
    print(f"maxsim_packed path inputs: Nq={pdm.shape[0]}, S={pdm.shape[1]}, "
          f"Ld={pdm.shape[2]}, {int(pdm.any(2).sum())} candidates with a "
          f"valid token, {int(pdm.sum())} valid tokens; bound "
          f"{path_bound:.4f} ms ({path_by}), plain {path_plain_ms:.4f} ms")
    print("maxsim_packed times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f"; {_hmma_count('maxsim_packed')}")
    return dict(name="maxsim_packed", route="cuda",
                source="src/repro_torch/csrc/maxsim_packed.cu",
                replaces="src/repro/kernels/maxsim_packed/kernel.py:66",
                **_launches("maxsim_packed"), max_abs_err=max(errs),
                ms=times[f"b={bits}"], plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, path_ms=times["path"],
                path_plain_ms=path_plain_ms, path_bound_ms=path_bound,
                parent_ms=times.get(f"b={bits} parent"),
                parent_path_ms=times.get("path parent"), times_ms=times,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL} at b=2 and b=4 "
                      f"(Nq={Nq}, S={S}, Ld={ids.shape[1]}), at the main "
                      f"path's own inputs"
                      f"{' (equal to the parent design)' if parent else ''}"
                      f" and at Lq={LONG_LQ}, S=256 (three "
                      f"launches); timed at b={bits}; bound: valid tokens' "
                      f"bytes, products at 3 passes of the TF32 rate "
                      f"{TF32_OPS_PER_S:.4g}/s, reconstruction at f32")


def _long_queries(torch, dev, Nq, dim, seed):
    """Unit query vectors of LONG_LQ tokens, about a tenth masked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((Nq, LONG_LQ, dim), generator=g, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    return q, torch.rand((Nq, LONG_LQ), generator=g, device=dev) > 0.1


def persist_path(rt, torch, model, queries, stats, S, I):
    """Serve the main build's artifact with ``Searcher.from_dir``: the
    same codes, kernels and card, so the results must be equal."""
    from repro_torch.core.persist import artifact_bytes

    def drive():
        t0 = time.perf_counter()
        searcher = rt.Searcher.from_dir(model, ARTIFACT_DIR,
                                        encode_batch=QUERY_BATCH)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        return searcher, load_s, _search_all(searcher, queries)

    loaded, load_s, (S1, I1) = run_path("from_dir", torch, drive)
    nbytes = artifact_bytes(ARTIFACT_DIR)
    print(f"artifact: {nbytes} bytes on disk (index_bytes "
          f"{stats.index_bytes}), device bytes after load "
          f"{loaded.index.device_bytes()} (build's {stats.device_bytes}); "
          f"load {load_s:.4f}s; save {stats.stage_seconds['save']:.4f}s")
    if nbytes != stats.index_bytes:
        raise AssertionError("artifact bytes differ from index_bytes")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("from_dir results differ from the in-memory "
                             "index's")
    print("from_dir: results equal the in-memory index's exactly")


def host_probe_path(torch, index, searcher, queries, S, I):
    """The same index through the host probe path (prune engaged at
    ndocs = 1024); then device and host steady search times."""
    index.probe_kernel = "host"
    S1, I1 = run_path("host_probe", torch,
                      lambda: _search_all(searcher, queries))
    _agree("host probe path vs device path", S, I, S1, I1)
    qv = searcher.encode_queries(queries)
    host_s = _steady_search_s(torch, searcher, qv)
    index.probe_kernel = "auto"
    dev_s = _steady_search_s(torch, searcher, qv)
    print(f"index search, {N_QUERIES} queries steady: device path "
          f"{dev_s:.4f}s, host path {host_s:.4f}s")


def dense_path(rt, torch, model, docs, queries):
    """A 512-doc plaid index where every doc is a candidate (nprobe = K):
    the device plan is refused, the slate reaches n_docs, and the rerank
    is the all-pairs ``maxsim`` scan with a membership mask."""
    from repro_torch.core.plaid import device_probe_plan

    def drive():
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(nprobe=256),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=128)
        index, _ = indexer.build(docs[:DENSE_DOCS])
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        return index, searcher, _search_all(searcher, queries)

    index, searcher, (S, I) = run_path("dense", torch, drive)
    if device_probe_plan(index._plaid, QUERY_LEN, index.nprobe,
                         index.ndocs)[0]:
        raise AssertionError("dense: the device plan was not refused")
    cand, _ = index.candidates(searcher.encode_queries(queries[:QUERY_BATCH]))
    print(f"dense: {index.n_docs} docs, ndocs {index.ndocs}, slate width "
          f"{cand.shape[1]}")
    if cand.shape[1] < index.n_docs:
        raise AssertionError("dense: the slate did not reach n_docs")
    _check_results(S, I, index.n_docs)
    _agree("dense path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))


def flat_path(rt, torch, model, docs, queries):
    """A 4,096-doc flat index (Ward f=2): all-pairs ``maxsim``."""

    def drive():
        t0 = time.perf_counter()
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(backend="flat"),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=128)
        index, stats = indexer.build(docs[:FLAT_DOCS])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        return index, stats, build_s, searcher, _search_all(searcher,
                                                            queries)

    index, stats, build_s, searcher, (S, I) = run_path("flat", torch, drive)
    _check_results(S, I, index.n_docs)
    search_s = _steady_search_s(torch, searcher,
                                searcher.encode_queries(queries))
    print(f"flat: {stats.n_docs} docs, {stats.n_vectors_stored} vectors, "
          f"build {build_s:.3f}s, index bytes {stats.index_bytes}, device "
          f"bytes {stats.device_bytes}; index search {N_QUERIES} queries "
          f"steady {search_s:.4f}s")
    _agree("flat path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    return capture_maxsim_args(torch, searcher, queries), index


def recon_path(torch, index, searcher, queries, S, I):
    """The main index reranked from the f32 reconstruction store; returns
    the ``maxsim_rerank_indexed`` arguments of its first batch (the
    path's own slate, read from the store in place)."""
    index.packed_rerank = False
    S1, I1 = run_path("recon_rerank", torch,
                      lambda: _search_all(searcher, queries))
    recon_s = _steady_search_s(torch, searcher,
                               searcher.encode_queries(queries))
    args = capture_rerank_args(torch, searcher, queries)
    index.packed_rerank = True
    print(f"recon rerank: store {index._plaid.recon.device_nbytes()} device "
          f"bytes; index search {N_QUERIES} queries steady {recon_s:.4f}s")
    _agree("recon rerank vs packed rerank", S, I, S1, I1)
    return args


def capture_rerank_args(torch, searcher, queries):
    """The arguments of the ``maxsim_rerank_indexed`` call of one search
    batch. Outside every counted run."""
    import repro_torch.kernels.maxsim.ops as mo
    seen = []
    inner = mo.maxsim_rerank_indexed

    def keep(*args, **kw):
        if not seen:
            seen.append(args)
        return inner(*args, **kw)

    mo.maxsim_rerank_indexed = keep
    try:
        searcher.search(queries[:QUERY_BATCH], k=TOP_K)
    finally:
        mo.maxsim_rerank_indexed = inner
    if not seen:
        raise AssertionError("the search batch made no maxsim_rerank call")
    return seen[0]


def mutate_path(rt, torch, model, queries):
    """The main artifact loaded a second time with ``Searcher.from_dir``
    (the main index stays as it is), 512 of its docs deleted and 1,024 new
    docs added (encoded and Ward-pooled by the model, from a corpus of
    another seed), then 64 queries. Fails where a deleted id comes back,
    where the host probe path or the plain versions disagree, where an
    added doc's own vectors do not find it at top-1, or where the index
    saved and served again gives other results."""
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    cfg = model.cfg
    extra = SyntheticRetrievalCorpus(DatasetSpec(
        "chip-smoke-add", n_docs=MUTATE_ADD, n_queries=1, n_topics=64,
        doc_len_mean=200, doc_len_std=40, seed=SEED + 7),
        vocab_size=cfg.trunk.vocab_size).doc_token_batch(cfg.doc_maxlen - 2)

    def drive():
        searcher = rt.Searcher.from_dir(model, ARTIFACT_DIR,
                                        encode_batch=QUERY_BATCH)
        index = searcher.index
        n0 = index.n_docs
        dead = np.random.default_rng(SEED + 7).choice(n0, MUTATE_DELETE,
                                                      replace=False)
        t0 = time.perf_counter()
        index.delete(dead)
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=ENCODE_BATCH)
        added = indexer.encode_and_pool(extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ids = index.add(added)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = _search_all(searcher, queries)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        picks = np.linspace(0, MUTATE_ADD - 1, MUTATE_SELF).astype(int)
        own = [index.search(added[i], k=TOP_K)[1] for i in picks]
        return (searcher, index, dead, ids, picks, own, res,
                dict(delete_encode_s=t1 - t0, add_s=t2 - t1,
                     search_s=t3 - t2))

    searcher, index, dead, ids, picks, own, (S, I), times = run_path(
        "mutate", torch, drive)
    print(f"mutate: {index.n_docs} docs ({MUTATE_DELETE} deleted, "
          f"{len(ids)} added as ids {ids[0]}..{ids[-1]}); device plan "
          f"{index._probe_plan(QUERY_LEN)[0]}; " + ", ".join(
              f"{k} {v:.4f}" for k, v in times.items()))
    _check_results(S, I, index.n_docs)
    if np.isin(I, dead).any():
        raise AssertionError("mutate: a deleted doc came back")
    top1 = [int(o[0]) if len(o) else -1 for o in own]
    hits = int(sum(t == ids[i] for t, i in zip(top1, picks)))
    print(f"mutate: added docs found at top-1 by their own vectors: "
          f"{hits} of {len(picks)}")
    if hits != len(picks):
        raise AssertionError(f"mutate: added docs not at top-1 of their own "
                             f"vectors: {list(zip(ids[picks], top1))}")
    index.probe_kernel = "host"
    _agree("mutate host probe path vs device path", S, I,
           *_search_all(searcher, queries))
    index.probe_kernel = "auto"
    _agree("mutate vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    shutil.rmtree(MUTATE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    index.save(MUTATE_DIR)
    save_s = time.perf_counter() - t0
    loaded = rt.Searcher.from_dir(model, MUTATE_DIR, encode_batch=QUERY_BATCH)
    S1, I1 = _search_all(loaded, queries)
    shutil.rmtree(MUTATE_DIR, ignore_errors=True)
    print(f"mutate: saved compacted in {save_s:.4f}s, {loaded.index.n_docs} "
          f"docs, {len(loaded.index.deleted)} dead")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("mutate: the reloaded index's results differ")
    print("mutate: reloaded results equal the mutated index's exactly")


def hnsw_path(rt, torch, model, docs, queries):
    """An hnsw index through ``Indexer.build`` (Ward f=4, 128 docs, the
    graph built in host Python), 16 docs added and 8 deleted, 32 queries:
    the token probes on the host, the rerank by ``maxsim_rerank`` reading
    the slate from the store in place. Held to the plain versions and to
    the flat backend's exact MaxSim over the same slate; saved and served
    again by ``Searcher.from_dir`` with equal results."""
    from repro_torch.core.maxsim import topk_with_pads
    nq = QUERY_BATCH

    def drive():
        t0 = time.perf_counter()
        indexer = rt.Indexer(
            model, index_spec=rt.IndexSpec(backend="hnsw",
                                           hnsw_candidates=HNSW_CANDIDATES),
            pooling_spec=rt.PoolingSpec("ward", HNSW_FACTOR),
            encode_batch=ENCODE_BATCH)
        index, stats = indexer.build(docs[:HNSW_DOCS])
        build_s = time.perf_counter() - t0
        more = indexer.encode_and_pool(docs[HNSW_DOCS:HNSW_DOCS + HNSW_ADD])
        t0 = time.perf_counter()
        index.add(more)
        add_s = time.perf_counter() - t0
        dead = np.random.default_rng(SEED + 8).choice(
            index.n_docs, HNSW_DELETE, replace=False)
        index.delete(dead)
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        t0 = time.perf_counter()
        res = searcher.search(queries[:nq], k=TOP_K)
        torch.cuda.synchronize()
        return (index, stats, build_s, add_s, dead, searcher, res,
                time.perf_counter() - t0)

    index, stats, build_s, add_s, dead, searcher, (S, I), search_s = \
        run_path("hnsw", torch, drive)
    qv = searcher.encode_queries(queries[:nq])
    cand, cmask = index.candidates(qv)
    counts = cmask.sum(1).float()
    cos = float(torch.einsum("qld,qmd->qlm", qv, qv).mean())
    print(f"hnsw: {index.n_docs} docs, {index._hnsw.vectors.shape[0]} token "
          f"vectors in the graph (M {index.hnsw_m}, ef_construction "
          f"{index.hnsw_ef_construction}); build {build_s:.3f}s (graph and "
          f"store: index stage {stats.stage_seconds['index']:.3f}s), add "
          f"{HNSW_ADD} docs {add_s:.3f}s; {nq} queries searched in "
          f"{search_s:.3f}s; slate width {cand.shape[1]}, valid per query "
          f"min {int(counts.min())} median {float(counts.median()):.0f} max "
          f"{int(counts.max())}; a query's tokens: mean pairwise cosine "
          f"{cos:.4f}")
    if cand.shape[1] >= index.n_docs:
        raise AssertionError("hnsw: the slate reached n_docs")
    found = I >= 0            # a slate of fewer than k docs pads with -1
    if not (np.isfinite(S[found]).all() and (I[found] < index.n_docs).all()
            and np.isneginf(S[~found]).all() and found[:, 0].all()):
        raise AssertionError("hnsw: invalid results")
    print(f"hnsw: results a query min {int(found.sum(1).min())} mean "
          f"{float(found.sum(1).mean()):.2f} of k = {TOP_K}")
    if np.isin(I, dead).any():
        raise AssertionError("hnsw: a deleted doc came back")
    _agree("hnsw vs plain versions", S, I,
           *searcher.search(queries[:nq], k=TOP_K, impl="ref"))
    flat = rt.MultiVectorIndex(dim=index.dim, backend="flat")
    flat.add(index.docs)
    flat.delete(dead)
    _agree("hnsw vs the flat backend's MaxSim over the hnsw slate", S, I,
           *topk_with_pads(flat.rerank(qv, cand, cmask), cand, TOP_K))
    shutil.rmtree(HNSW_DIR, ignore_errors=True)
    index.save(HNSW_DIR)
    loaded = rt.Searcher.from_dir(model, HNSW_DIR, encode_batch=QUERY_BATCH)
    S1, I1 = loaded.search(queries[:nq], k=TOP_K)
    shutil.rmtree(HNSW_DIR, ignore_errors=True)
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("hnsw: from_dir results differ")
    print("hnsw: from_dir results equal the in-memory index's exactly")


def plaid_k8192_path(rt, torch, model, flat_index, queries):
    """A plaid index at K = 8,192 over the flat path's stored pooled
    vectors (``add_flat``: nothing encoded again), nprobe 32, ndocs 16
    (``K8192_NPROBE``: the prune then cuts every query's slate). Its
    ``doc_member`` (8,192 x 4,096) is above the gather cap, so ``"auto"``
    takes the host path; ``probe_kernel="device"`` forces the device
    path. Both prune with ``plaid_probe`` at K = 8,192 (the global-table
    route) and must agree with each other and with the plain versions."""
    from repro_torch.core.plaid import (_centroid_scores_batch, _ladder,
                                        probe_members)
    store = flat_index._store

    def drive():
        t0 = time.perf_counter()
        index = rt.MultiVectorIndex(dim=flat_index.dim, n_centroids=K8192,
                                    nprobe=K8192_NPROBE, ndocs=K8192_NDOCS)
        index.add_flat(store.flat, store.doc_lengths())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        t0 = time.perf_counter()
        host = _search_all(searcher, queries)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        index.probe_kernel = "device"
        t0 = time.perf_counter()
        device = _search_all(searcher, queries)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - t0
        return index, searcher, build_s, host, host_s, device, device_s

    index, searcher, build_s, (S, I), host_s, (S1, I1), device_s = run_path(
        "plaid_k8192", torch, drive)
    index.probe_kernel = "auto"
    if index._probe_plan(QUERY_LEN)[0]:
        raise AssertionError("plaid_k8192: auto took the device path")
    index.probe_kernel = "device"
    if not index._probe_plan(QUERY_LEN)[0]:
        raise AssertionError("plaid_k8192: the device path was refused")
    qv = searcher.encode_queries(queries)
    counts = _candidate_report(torch, index, qv)
    p = index._plaid
    _, at8 = probe_members(_centroid_scores_batch(qv, p.codec.centroids),
                           torch.ones(qv.shape[:2], dtype=torch.bool,
                                      device=qv.device),
                           p.device_ivf().doc_member,
                           torch.ones(p.n_docs, dtype=torch.bool,
                                      device=qv.device), 8)
    print(f"plaid_k8192: at nprobe 8 (the default), candidates per query "
          f"min {int(at8.min())} max {int(at8.max())}")
    pruned = [_ladder(int(counts[lo:lo + QUERY_BATCH].max())) > index.ndocs
              for lo in range(0, len(counts), QUERY_BATCH)]
    cut = int((counts > index.ndocs).sum())
    print(f"plaid_k8192: {p.n_docs} docs, {p.n_vectors} vectors, K "
          f"{p.codec.n_centroids}; build {build_s:.3f}s; {N_QUERIES} queries "
          f"host path {host_s:.4f}s, device path {device_s:.4f}s (first "
          f"pass); "
          f"batches pruned {pruned}, queries cut to ndocs {cut} of "
          f"{len(counts)}")
    if not all(pruned):
        raise AssertionError("plaid_k8192: the prune did not engage")
    _check_results(S, I, p.n_docs)
    _agree("plaid_k8192 host path vs device path", S, I, S1, I1)
    _agree("plaid_k8192 device path vs plain versions", S1, I1,
           *_search_all(searcher, queries, impl="ref"))
    index.probe_kernel = "auto"
    _agree("plaid_k8192 host path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    return capture_probe_args(searcher, queries)


def capture_probe_args(searcher, queries):
    """The arguments of the ``plaid_probe`` call of one search batch.
    Outside every counted run."""
    import repro_torch.core.plaid as cp
    seen = []
    inner = cp.plaid_probe_scores

    def keep(*args, **kw):
        seen.append(args)
        return inner(*args, **kw)

    cp.plaid_probe_scores = keep
    try:
        searcher.search(queries[:QUERY_BATCH], k=TOP_K)
    finally:
        cp.plaid_probe_scores = inner
    if not seen:
        raise AssertionError("the search batch made no plaid_probe call")
    return seen[0]


def _n_valid(cfg, docs):
    """Emitted (stored before pooling) vectors per doc, from the tokens."""
    import torch
    from repro_torch.models.colbert import emit_mask_docs, prepare_doc_tokens
    toks, attn = prepare_doc_tokens(torch.from_numpy(np.asarray(docs)),
                                    cfg.doc_maxlen)
    return emit_mask_docs(toks, attn, cfg.mask_punctuation).sum(1).numpy()


def kmeans_path(rt, torch, model, docs, queries):
    """A 4,096-doc plaid index pooled by per-document k-means (f=2)."""
    n_batches = -(-KMEANS_DOCS // ENCODE_BATCH)

    def drive():
        t0 = time.perf_counter()
        indexer = rt.Indexer(model,
                             index_spec=rt.IndexSpec(ndocs=KMEANS_NDOCS),
                             pooling_spec=rt.PoolingSpec("kmeans", 2),
                             encode_batch=ENCODE_BATCH)
        index, stats = indexer.build(docs[:KMEANS_DOCS])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        res = _search_all(searcher, queries)
        # no counted kernel runs here: printed before the launch check
        _candidate_report(torch, index, searcher.encode_queries(queries))
        return index, stats, build_s, searcher, res

    index, stats, build_s, searcher, (S, I) = run_path("kmeans", torch,
                                                       drive)
    launches = PATH_LAUNCHES["kmeans"]["kmeans_assign"]
    print(f"kmeans: {stats.n_docs} docs, build {build_s:.3f}s; stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in stats.stage_seconds.items())
          + f"; vectors raw {stats.n_vectors_raw}, stored "
          f"{stats.n_vectors_stored} (reduction {stats.vector_reduction:.4f});"
          f" kmeans_assign launches {launches} = 11 x {n_batches} encode "
          f"batches: {launches == 11 * n_batches}")
    if launches != 11 * n_batches:
        raise AssertionError("kmeans: kmeans_assign launches are not 11 per "
                             "encode batch")
    stored = np.diff(index._plaid.doc_offsets)
    cap = _n_valid(model.cfg, docs[:KMEANS_DOCS]) // 2 + 1
    if (stored > cap).any():
        raise AssertionError(f"kmeans: {int((stored > cap).sum())} docs "
                             f"store more than n_valid // 2 + 1 vectors")
    _check_results(S, I, index.n_docs)
    search_s = _steady_search_s(torch, searcher,
                                searcher.encode_queries(queries))
    print(f"kmeans: index search {N_QUERIES} queries steady {search_s:.4f}s")
    _agree("kmeans path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))


def sequential_path(rt, torch, model, docs, queries):
    """A 1,024-doc flat index pooled by sequential runs (f=2)."""

    def drive():
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(backend="flat"),
                             pooling_spec=rt.PoolingSpec("sequential", 2),
                             encode_batch=ENCODE_BATCH)
        index, stats = indexer.build(docs[:SEQUENTIAL_DOCS])
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        return index, stats, _search_all(searcher, queries)

    index, stats, (S, I) = run_path("sequential", torch, drive)
    want = -(-_n_valid(model.cfg, docs[:SEQUENTIAL_DOCS]) // 2)
    stored = index._store.doc_lengths()
    print(f"sequential: {stats.n_docs} docs, vectors raw "
          f"{stats.n_vectors_raw}, stored {stats.n_vectors_stored}")
    if not np.array_equal(stored, want):
        raise AssertionError(f"sequential: {int((stored != want).sum())} "
                             f"docs do not store ceil(n_valid / 2) vectors")
    _check_results(S, I, index.n_docs)


def cascade_path(rt, torch, model, docs, queries):
    """``build_cascade`` with the reference's defaults over 4,096 docs."""

    def drive():
        t0 = time.perf_counter()
        cascade = rt.build_cascade(model, docs[:CASCADE_DOCS],
                                   encode_batch=ENCODE_BATCH)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, cascade, encode_batch=QUERY_BATCH)
        return cascade, build_s, searcher, _search_all(searcher, queries)

    cascade, build_s, searcher, (S, I) = run_path("cascade", torch, drive)
    _check_results(S, I, cascade.n_docs)
    search_s = _steady_search_s(torch, searcher,
                                searcher.encode_queries(queries))
    print(f"cascade: {cascade.n_docs} docs, coarse (f={cascade.coarse_factor})"
          f" {cascade.stage1_vectors()} + fine (f={cascade.fine_factor}) "
          f"{cascade.n_vectors() - cascade.stage1_vectors()} vectors, "
          f"{cascade.candidates} candidates; build {build_s:.3f}s; device "
          f"bytes {cascade.device_bytes()}; index search {N_QUERIES} "
          f"queries steady {search_s:.4f}s")
    _agree("cascade vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    return cascade, S, I, capture_rerank_args(torch, searcher, queries)


def cascade_from_dir_path(rt, torch, model, queries, cascade, S, I):
    """The cascade saved, then served by ``Searcher.from_dir``: the same
    vectors, kernels and card, so the results must be equal."""
    from repro_torch.core.persist import artifact_bytes
    shutil.rmtree(CASCADE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    cascade.save(CASCADE_DIR)
    save_s = time.perf_counter() - t0

    def drive():
        t0 = time.perf_counter()
        searcher = rt.Searcher.from_dir(model, CASCADE_DIR,
                                        encode_batch=QUERY_BATCH)
        torch.cuda.synchronize()
        return searcher, time.perf_counter() - t0, _search_all(searcher,
                                                               queries)

    loaded, load_s, (S1, I1) = run_path("cascade_from_dir", torch, drive)
    if not isinstance(loaded.index, rt.CascadeIndex):
        raise AssertionError(f"from_dir served a {type(loaded.index)}")
    print(f"cascade artifact: {artifact_bytes(CASCADE_DIR)} bytes, save "
          f"{save_s:.4f}s, load {load_s:.4f}s")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("cascade from_dir results differ from the "
                             "in-memory cascade's")
    print("cascade_from_dir: results equal the in-memory cascade's exactly")
    shutil.rmtree(CASCADE_DIR, ignore_errors=True)


def facade_path(rt, torch, model, queries, S, I):
    """``Retriever.load`` of the main artifact: the spec read back from
    its manifest is the main path's, and its search gives the main
    path's results exactly (the same codes, kernels and card)."""
    want = rt.RetrieverSpec(pooling=rt.PoolingSpec("ward", 2),
                            index=rt.IndexSpec(ndocs=NDOCS))

    def drive():
        r = rt.Retriever.load(model, ARTIFACT_DIR, encode_batch=QUERY_BATCH)
        return r, _search_all(r, queries)

    r, (S1, I1) = run_path("facade", torch, drive)
    print(f"facade: spec {r.spec.to_dict()}; stats n_docs {r.stats.n_docs}")
    if r.spec != want:
        raise AssertionError(f"facade: spec {r.spec} is not the main "
                             f"path's {want}")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("facade: Retriever.load results differ from "
                             "the main path's")
    print("facade: spec and results equal the main path's exactly")


def _shard_report(torch, sharded, qv):
    """Each shard's docs, vectors and per-query candidate counts."""
    for i, (base, shard) in enumerate(zip(sharded.doc_base, sharded.shards)):
        print(f"  shard {i}: ids {base}..{base + shard.n_docs - 1}, "
              f"{shard.n_docs} docs, {shard.n_vectors()} vectors; ", end="")
        _candidate_report(torch, shard, qv)


def stream_path(rt, torch, model, docs, queries, card):
    """The main corpus streamed through ``Retriever.build`` with a
    ``ShardSpec`` into shards of at most 524,288 pooled vectors, saved
    shard by shard (pipelined flush), then 64 queries. A shard holds
    ~5,000 docs, whose candidate sets stay under 1024 at random weights
    (as the kmeans path's 4,096 docs), so the main path's ndocs = 1024
    would never prune: the shards take PLAID's k = 10 setting, ndocs =
    256, where ``plaid_probe`` prunes. Held tie-aware against the plain
    versions, the host probe path and ``Retriever.load`` of the artifact
    (which must give back the spec); then index search timed with the
    probe pool at auto and at one thread, on both candidate paths."""
    spec = rt.RetrieverSpec(
        pooling=rt.PoolingSpec("ward", 2),
        index=rt.IndexSpec(ndocs=STREAM_NDOCS),
        shard=rt.ShardSpec(shard_max_vectors=STREAM_SHARD_MAX))
    shutil.rmtree(STREAM_DIR, ignore_errors=True)

    def drive():
        t0 = time.perf_counter()
        r = rt.Retriever.build(model, docs, spec, out_dir=STREAM_DIR,
                               encode_batch=ENCODE_BATCH)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        r.searcher.encode_batch = QUERY_BATCH
        return r, build_s, _search_all(r, queries)

    r, build_s, (S, I) = run_path("stream", torch, drive)
    st, sharded = r.stats, r.index
    print(f"stream ({card}): {st.n_docs} docs, {st.n_shards} shards, "
          f"{st.n_vectors_stored} vectors (raw {st.n_vectors_raw}); build "
          f"{build_s:.3f}s = {st.n_docs / build_s:.1f} docs/s (main build "
          f"{MAIN_NUMBERS['build_docs_s']:.1f} docs/s); stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in st.stage_seconds.items()))
    print(f"stream ({card}): peak_buffered_vectors "
          f"{st.peak_buffered_vectors} (bound {STREAM_SHARD_MAX} + "
          f"max_batch_vectors {st.max_batch_vectors}); flush_wait_s "
          f"{st.flush_wait_s:.4f}; flush_busy_s {st.flush_busy_s:.4f}; "
          f"pipelined {st.pipelined}; index bytes {st.index_bytes}; device "
          f"bytes {st.device_bytes}")
    qv = r.searcher.encode_queries(queries)
    _shard_report(torch, sharded, qv[:QUERY_BATCH])
    if st.n_shards < 2 or st.n_docs != len(docs):
        raise AssertionError(f"stream: {st.n_shards} shards, {st.n_docs} "
                             f"docs")
    if st.peak_buffered_vectors > STREAM_SHARD_MAX + st.max_batch_vectors:
        raise AssertionError("stream: the pooled buffer outgrew its bound")
    _check_results(S, I, st.n_docs)
    _agree("stream vs plain versions", S, I,
           *_search_all(r.searcher, queries, impl="ref"))
    sharded.set_probe_kernel("host")
    _agree("stream host probe path vs device path", S, I,
           *_search_all(r, queries))
    sharded.set_probe_kernel("auto")
    loaded = rt.Retriever.load(model, STREAM_DIR, encode_batch=QUERY_BATCH)
    if loaded.spec != spec:
        raise AssertionError(f"stream: Retriever.load read back "
                             f"{loaded.spec}, built with {spec}")
    S1, I1 = _search_all(loaded, queries)
    _agree("stream Retriever.load vs built", S, I, S1, I1)
    print(f"stream: Retriever.load gives back the spec; results equal "
          f"exactly: {bool(np.array_equal(I, I1) and np.array_equal(S, S1))}")
    loaded.index.close()
    # the pool on the device candidate path, and on the host path (numpy,
    # the stage the reference's pool overlaps)
    for kernel in ("auto", "host"):
        sharded.set_probe_kernel(kernel)
        for pt in (0, 1):
            sharded.set_probe_threads(pt)
            search_s = _steady_search_s(torch, r.searcher, qv)
            _, _, probe_s = sharded.search_batch_with_stats(
                qv[:QUERY_BATCH], k=TOP_K)
            print(f"stream ({card}): index search {N_QUERIES} queries "
                  f"steady {search_s:.4f}s, probe_kernel {kernel}, "
                  f"probe_threads {pt} ({sharded.probe_threads} workers; "
                  f"main path {MAIN_NUMBERS['index_search_s']:.4f}s); "
                  "per-shard probe s of one batch "
                  + ", ".join(f"{p:.4f}" for p in probe_s))
    sharded.close()
    shutil.rmtree(STREAM_DIR, ignore_errors=True)


def _payload_digests(root):
    """{shard dir/payload name: sha256 of its .npy bytes}."""
    import hashlib
    from repro_torch.core.persist import read_manifest
    out = {}
    for e in read_manifest(root)["shards"]:
        sub = os.path.join(root, e["dir"])
        for name, p in read_manifest(sub)["payloads"].items():
            with open(os.path.join(sub, p["file"]), "rb") as fh:
                out[f"{e['dir']}/{name}"] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def stream_parity_path(rt, torch, model, docs, queries, card):
    """The first 4,096 docs streamed into ~4 shards with the flush
    pipelined and serial: every shard payload's sha256, the doc ids and
    the shard bases must be equal. At exhaustive settings (nprobe = K =
    256, ndocs 4,096: every shard takes the dense fallback through
    ``maxsim``) the sharded search must equal a monolithic
    ``Indexer.build`` of the same docs with the first shard's codec:
    ids tie-aware within 1e-5."""
    spec = rt.IndexSpec(nprobe=256, ndocs=PARITY_DOCS)
    sub = docs[:PARITY_DOCS]
    shutil.rmtree(PARITY_DIR, ignore_errors=True)

    def indexer():
        return rt.Indexer(model, index_spec=spec,
                          pooling_spec=rt.PoolingSpec("ward", 2),
                          encode_batch=ENCODE_BATCH)

    def drive():
        built = {}
        for pipe in (True, False):
            out = os.path.join(PARITY_DIR, f"pipeline_{pipe}")
            built[pipe] = indexer().build_streaming(
                sub, shard_max_vectors=PARITY_SHARD_MAX, out_dir=out,
                pipeline=pipe) + (out,)
        sharded = built[True][0]
        mono, _ = indexer().build(sub, codec=sharded.codec())
        searcher = rt.Searcher(model, sharded, encode_batch=QUERY_BATCH)
        mono_searcher = rt.Searcher(model, mono, encode_batch=QUERY_BATCH)
        return (built, mono, _search_all(searcher, queries),
                _search_all(mono_searcher, queries))

    built, mono, (S, I), (S0, I0) = run_path("stream_parity", torch, drive)
    (a, sa, da), (b, sb, db) = built[True], built[False]
    ha, hb = _payload_digests(da), _payload_digests(db)
    print(f"stream_parity ({card}): {sa.n_shards} shards of "
          f"{[s.n_docs for s in a.shards]} docs; {len(ha)} payloads; "
          f"pipelined flush_wait_s {sa.flush_wait_s:.4f} busy "
          f"{sa.flush_busy_s:.4f}, serial busy {sb.flush_busy_s:.4f}")
    differ = sorted(k for k in set(ha) | set(hb) if ha.get(k) != hb.get(k))
    if differ:
        raise AssertionError(f"stream_parity: pipelined and serial payloads "
                             f"differ: {differ}")
    if a.doc_base != b.doc_base or [s.n_docs for s in a.shards] != \
            [s.n_docs for s in b.shards]:
        raise AssertionError("stream_parity: shard layouts differ")
    print("stream_parity: pipelined and serial shard payloads have equal "
          "sha256, equal doc ids and bases")
    qv = rt.Searcher(model, a).encode_queries(queries[:QUERY_BATCH])
    for s in a.shards:
        cand, _ = s.candidates(qv)
        if cand.shape[1] < s.n_docs:
            raise AssertionError("stream_parity: a shard's slate did not "
                                 "reach n_docs")
    from repro_torch.core.maxsim import tie_aware_mismatches
    bad = tie_aware_mismatches(I0, S0, I, S, PARITY_ATOL)
    diff = float(np.abs(S - S0).max())
    print(f"stream_parity ({card}): sharded vs monolithic (same codec, "
          f"exhaustive): ids equal {float((I == I0).mean()):.4f}, tie-aware "
          f"mismatches {bad}, max score diff {diff:.3g} (zero: "
          f"{diff == 0.0})")
    _check_results(S, I, mono.n_docs)
    if bad or not np.allclose(S, S0, rtol=0, atol=PARITY_ATOL):
        raise AssertionError("stream_parity: sharded and monolithic "
                             "results disagree")
    a.close()
    b.close()
    shutil.rmtree(PARITY_DIR, ignore_errors=True)


def capture_path_args(torch, searcher, queries):
    """The arguments of the ``plaid_probe`` and ``maxsim_packed`` calls of
    the first main-path batch whose prune engages (both kernels run), and
    that batch's encoded queries. Outside every counted run."""
    import repro_torch.core.plaid as cp
    seen = {}

    def keep(name, fn):
        def wrapped(*args, **kw):
            seen.setdefault(name, args)
            return fn(*args, **kw)
        return wrapped

    probe, packed = cp.plaid_probe_scores, cp.maxsim_packed_rerank
    cp.plaid_probe_scores = keep("plaid_probe", probe)
    cp.maxsim_packed_rerank = keep("maxsim_packed", packed)
    try:
        for lo in range(0, len(queries), QUERY_BATCH):
            seen.clear()
            qv = searcher.encode_queries(queries[lo:lo + QUERY_BATCH])
            searcher.search_encoded(qv, k=TOP_K)
            if len(seen) == 2:
                return seen["plaid_probe"], seen["maxsim_packed"], qv
    finally:
        cp.plaid_probe_scores, cp.maxsim_packed_rerank = probe, packed
    raise AssertionError("no main-path batch ran both plaid_probe and "
                         "maxsim_packed")


# The ``search.*`` ranges of one batch: the main path's (packed rerank)
# and the recon_rerank path's (the f32 rerank from the store)
CANDIDATE_STAGES = ("search.centroid_scores", "search.probe_members",
                    "search.code_gather", "search.plaid_probe",
                    "search.prune")
SPLIT_STAGES = CANDIDATE_STAGES + ("search.packed_gather",
                                   "search.maxsim_packed", "search.topk")
RECON_STAGES = CANDIDATE_STAGES + ("search.maxsim_rerank", "search.topk")


# Kernels each of these stages must show in the trace.
STAGE_KERNELS = {"search.plaid_probe": ("plaid_table_kernel",
                                        "plaid_probe_kernel"),
                 "search.maxsim_packed": ("maxsim_packed_kernel",),
                 "search.maxsim_rerank": ("maxsim_tc_kernel",)}


def search_split(torch, searcher, qv, stages=SPLIT_STAGES, label="main"):
    """Device time of each stage (``stages``) of one ``search_encoded``
    batch, from a ``torch.profiler`` trace of that call. Each device activity
    (kernel or copy) is matched to the runtime call that launched it (the
    two share an id) and given to the innermost ``search.*`` range around
    that call (``core/plaid.py``, ``core/index.py``): ctypes launches
    count as aten's do. The batch's time on the device's clock (CUDA
    events around the call) against all its device work gives the
    device's idle share. Raises where a stage shows no device time (the
    prune must engage) or misses its kernels. -> {stage: ms, "batch": ms,
    "device busy": ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    searcher.search_encoded(qv, k=TOP_K)            # warm
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        searcher.search_encoded(qv, k=TOP_K)
        end.record()
        torch.cuda.synchronize()
    events = prof.events()
    calls = {e.id: e for e in events                # runtime calls: cuda*
             if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    split = dict.fromkeys(stages, 0.0)
    names = {k: set() for k in stages}
    busy = 0.0
    for w in events:
        if w.device_type != DeviceType.CUDA or w.is_user_annotation:
            continue
        ms = w.time_range.elapsed_us() / 1e3
        busy += ms
        p = calls.get(w.id)
        while p is not None and p.name not in split:
            p = p.cpu_parent
        if p is not None:
            split[p.name] += ms
            names[p.name].add(w.name)
    for name in stages:
        missing = [k for k in STAGE_KERNELS.get(name, ())
                   if not any(k in n for n in names[name])]
        if split[name] <= 0 or missing:
            raise AssertionError(f"split: {name} shows {split[name]} ms of "
                                 f"device time, kernels missing {missing}")
    staged = sum(split.values())
    split["batch"] = start.elapsed_time(end)
    split["device busy"] = busy
    print(f"{label} index search split of one {qv.shape[0]}-query batch "
          f"(torch.profiler device time, ms; the batch "
          f"{split['batch']:.4f} ms on CUDA events, the device busy "
          f"{busy:.4f} ms, idle share {1 - busy / split['batch']:.3f}, "
          f"outside the stages {busy - staged:.4f}): " + ", ".join(
              f"{k[len('search.'):]} {split[k]:.4f}" for k in stages))
    return split


# The C entries an earlier checkout must declare for ``--parent``, by
# source: the designs of this checkout's parent (commit a762eb8). The
# plaid_probe, maxsim_packed, kmeans_assign and all-pairs maxsim entries
# are this checkout's designs too, so their scores must be bit-equal; the
# rerank (f32 FMA from gathered candidates) and dequant_score (f32 FMA)
# are the designs this checkout replaces.
PARENT_ABI = {
    "plaid_probe": {
        "plaid_probe_launch": "int plaid_probe_launch(const float* q, const "
        "uint8_t* qmask, const float* centroids, const int32_t* codes, const "
        "uint8_t* cmask, const uint8_t* vmask, float* table, float* out, int "
        "Nq, int Lq, int dim, int K, int C, int L, float t_cs, void* "
        "stream)"},
    "maxsim_packed": {
        "maxsim_packed_launch": "int maxsim_packed_launch(const float* q, "
        "const uint8_t* qmask, const uint32_t* words, const int32_t* ids, "
        "const uint8_t* dmask, const float* centroids, const float* values, "
        "float* out, int Nq, int Lq, int dim, int S, int Ld, int W, int "
        "bits, void* stream)"},
    "kmeans_assign": {
        "kmeans_assign_launch": "int kmeans_assign_launch(const float* x, "
        "const float* centroids, const uint8_t* kmask, int32_t* assign, "
        "float* best, int B, int N, int K, int dim, void* stream)"},
    "maxsim": {
        "maxsim_launch": "int maxsim_launch(const float* q, const uint8_t* "
        "qmask, const float* d, const uint8_t* dmask, float* out, int Nq, "
        "int Lq, int dim, int Nd, int Ld, void* stream)",
        "maxsim_rerank_launch": "int maxsim_rerank_launch(const float* q, "
        "const uint8_t* qmask, const float* d, const uint8_t* dmask, float* "
        "out, int Nq, int Lq, int dim, int S, int Ld, void* stream)"},
    "dequant_score": {
        "dequant_score_launch": "int dequant_score_launch(const uint32_t* "
        "words, const int32_t* ids, const float* centroids, const float* "
        "values, const float* q, float* out, int M, int Lq, int dim, int W, "
        "int bits, void* stream)"},
}


def parent_kernels(parent):
    """The entries of ``PARENT_ABI`` from an earlier checkout at
    ``parent``, a directory inside this checkout holding its
    ``src/repro_torch/csrc``, built with the same nvcc flags (one process
    per source, started together), as callables on the wrappers'
    arguments (at most 128 query tokens); {} without one. Raises unless
    each source declares its ``PARENT_ABI`` entries."""
    import ctypes
    import re
    import torch
    from repro_torch.kernels import build
    if not parent:
        return {}
    root = os.path.realpath(parent)
    if not root.startswith(os.path.realpath(ROOT) + os.sep):
        raise ValueError(f"--parent {parent}: not a directory inside "
                         f"{ROOT}")
    csrc = os.path.join(root, "src", "repro_torch", "csrc")
    for name, entries in PARENT_ABI.items():
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            text = f.read()
        for fn, want in entries.items():
            decl = re.search(rf'extern "C" (int {fn}\([^)]*\))', text)
            if decl is None or " ".join(decl.group(1).split()) != want:
                raise ValueError(f"--parent {parent}: {name}.cu does not "
                                 f"declare the entry this script calls: "
                                 f"{want}")
    out = os.path.join(ROOT, "build", "parent_kernels")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name in PARENT_ABI:
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the parent's {name} does not build:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    probe = libs["plaid_probe"].plaid_probe_launch
    probe.argtypes = [P] * 8 + [I] * 6 + [ctypes.c_float, P]
    table_floats = libs["plaid_probe"].plaid_probe_table_floats
    table_floats.argtypes = [I, I, I]
    table_floats.restype = ctypes.c_size_t
    packed = libs["maxsim_packed"].maxsim_packed_launch
    packed.argtypes = [P] * 8 + [I] * 7 + [P]
    assign = libs["kmeans_assign"].kmeans_assign_launch
    assign.argtypes = [P] * 5 + [I] * 4 + [P]
    allpairs = libs["maxsim"].maxsim_launch
    allpairs.argtypes = [P] * 5 + [I] * 5 + [P]
    rerank = libs["maxsim"].maxsim_rerank_launch
    rerank.argtypes = [P] * 5 + [I] * 5 + [P]
    dequant = libs["dequant_score"].dequant_score_launch
    dequant.argtypes = [P] * 6 + [I] * 5 + [P]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_probe(q, qm, cen, codes, cm, vm, t_cs):
        (Nq, Lq, dim), (K, _), (_, C, L) = q.shape, cen.shape, codes.shape
        o = torch.empty((Nq, C), dtype=torch.float32, device=q.device)
        table = torch.empty(table_floats(Nq, Lq, K), dtype=torch.float32,
                            device=q.device)
        build.check(probe(q.data_ptr(), qm.data_ptr(), cen.data_ptr(),
                          codes.data_ptr(), cm.data_ptr(), vm.data_ptr(),
                          table.data_ptr(), o.data_ptr(), Nq, Lq, dim, K, C,
                          L, float(t_cs), stream()), "parent plaid_probe")
        return o

    def run_packed(q, qm, w, a, dm, cen, vals, bits):
        (Nq, Lq, dim), (_, S, Ld, W) = q.shape, w.shape
        o = torch.empty((Nq, S), dtype=torch.float32, device=q.device)
        build.check(packed(q.data_ptr(), qm.data_ptr(), w.data_ptr(),
                           a.data_ptr(), dm.data_ptr(), cen.data_ptr(),
                           vals.data_ptr(), o.data_ptr(), Nq, Lq, dim, S, Ld,
                           W, bits, stream()), "parent maxsim_packed")
        return o

    def run_assign(x, c, km):
        (B, N, dim), K = x.shape, c.shape[1]
        a = torch.empty((B, N), dtype=torch.int32, device=x.device)
        b = torch.empty((B, N), dtype=torch.float32, device=x.device)
        build.check(assign(x.data_ptr(), c.data_ptr(), km.data_ptr(),
                           a.data_ptr(), b.data_ptr(), B, N, K, dim,
                           stream()), "parent kmeans_assign")
        return a, b

    def run_allpairs(q, qm, d, dm):
        (Nq, Lq, dim), (Nd, Ld, _) = q.shape, d.shape
        o = torch.empty((Nq, Nd), dtype=torch.float32, device=q.device)
        build.check(allpairs(q.data_ptr(), qm.data_ptr(), d.data_ptr(),
                             dm.data_ptr(), o.data_ptr(), Nq, Lq, dim, Nd, Ld,
                             stream()), "parent maxsim")
        return o

    def run_rerank(q, qm, d, dm):
        (Nq, Lq, dim), (_, S, Ld, _) = q.shape, d.shape
        o = torch.empty((Nq, S), dtype=torch.float32, device=q.device)
        build.check(rerank(q.data_ptr(), qm.data_ptr(), d.data_ptr(),
                           dm.data_ptr(), o.data_ptr(), Nq, Lq, dim, S, Ld,
                           stream()), "parent maxsim_rerank")
        return o

    def run_dequant(w, cid, cen, vals, q, bits):
        (M, W), (Lq, dim) = w.shape, q.shape
        o = torch.empty((M, Lq), dtype=torch.float32, device=q.device)
        build.check(dequant(w.data_ptr(), cid.data_ptr(), cen.data_ptr(),
                            vals.data_ptr(), q.data_ptr(), o.data_ptr(), M,
                            Lq, dim, W, bits, stream()),
                    "parent dequant_score")
        return o

    return {"plaid_probe": run_probe, "maxsim_packed": run_packed,
            "kmeans_assign": run_assign, "maxsim": run_allpairs,
            "maxsim_rerank": run_rerank, "dequant_score": run_dequant}


def _launches(name):
    by_path = {p: c[name] for p, c in PATH_LAUNCHES.items() if c[name]}
    return dict(launches=sum(by_path.values()), launches_by_path=by_path)


def _allpairs_bound(q, qm, d, dm):
    """Bytes: q, d and their masks read once, the scores written once;
    operations: 2 dim x valid query tokens x valid doc tokens, three passes
    at the TF32 tensor-core rate (-> bound, by, and the f32 bound)."""
    dim = q.shape[2]
    n_bytes = _nbytes(q, qm, d, dm) + q.shape[0] * d.shape[0] * 4
    ops = 2 * dim * int(qm.sum()) * int(dm.sum())
    bound, by = _bound_ms(n_bytes, ops * TF32_PASSES, TF32_OPS_PER_S)
    return bound, by, _bound_ms(n_bytes, ops)[0]


def capture_maxsim_args(torch, searcher, queries):
    """The arguments of the all-pairs ``maxsim`` call of one search batch
    (the flat path's own inputs). Outside every counted run."""
    import repro_torch.kernels.maxsim.ops as mo
    seen = []
    inner = mo.maxsim

    def keep(*args, **kw):
        if not seen:
            seen.append(args)
        return inner(*args, **kw)

    mo.maxsim = keep
    try:
        searcher.search(queries[:QUERY_BATCH], k=TOP_K)
    finally:
        mo.maxsim = inner
    if not seen:
        raise AssertionError("the search batch made no maxsim call")
    return seen[0]


def check_maxsim(torch, dev, index, qv, flat_args, parent):
    """All-pairs kernel at the recon store's full width (Nd = 16,384) and
    at the flat path's own inputs (``flat_args``), each held to the plain
    version; timed beside the parent design where ``parent`` holds it
    (whose scores must be equal), and beside ``torch.matmul`` of the same
    product alone (TF32 off): no port, no library_ms (it leaves out the
    masked maxima and sums)."""
    from repro_torch.kernels.maxsim.ops import maxsim
    d, dm = index._plaid.recon_store().padded()
    dm = dm.clone()
    dm[0] = False                                # an all-masked doc
    Nq, Lq, dim = qv.shape
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False                           # masked query tokens
    cases = {"synthetic": (qv, qm, d, dm), "flat path": flat_args}
    errs, times = [], {}
    for what, args in cases.items():
        got = maxsim(*args)
        want = maxsim(*args, impl="ref")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs.append(err)
        if not torch.allclose(got, want, rtol=1e-5, atol=SCORE_ATOL):
            raise AssertionError(f"maxsim {what}: max abs err {err}")
        dead = ~args[3].any(1)
        if bool(dead.any()) and float(got[:, dead].abs().max()) != 0.0:
            raise AssertionError(f"maxsim {what}: an all-masked doc did not "
                                 f"score 0")
        times[what] = _time_ms(lambda: maxsim(*args))
        if parent:
            if not torch.equal(parent["maxsim"](*args), got):
                raise AssertionError(f"maxsim {what}: differs from the "
                                     f"parent design's scores")
            times[what + " parent"] = _time_ms(lambda: parent["maxsim"](*args))
        del got, want
    # the product alone, [Nq Lq, dim] x [dim, Nd Ld] in f32 (TF32 off)
    mm = {}
    for what, (q, _, dd, _) in cases.items():
        a, b = q.reshape(-1, q.shape[2]), dd.reshape(-1, dd.shape[2])
        buf = torch.empty((a.shape[0], b.shape[0]), device=dev)
        mm[what] = _time_ms(lambda: torch.matmul(a, b.T, out=buf), reps=2)
        del buf
    bound, by, f32_bound = _allpairs_bound(qv, qm, d, dm)
    path_bound, path_by, path_f32 = _allpairs_bound(*flat_args)
    fq, fqm, fd, fdm = flat_args
    print(f"maxsim flat path inputs: Nq={fq.shape[0]}, Lq={fq.shape[1]}, "
          f"Nd={fd.shape[0]}, Ld={fd.shape[1]}, {int(fdm.sum())} valid doc "
          f"tokens; bound {path_bound:.4f} ms ({path_by}; f32 "
          f"{path_f32:.4f})")
    print("maxsim times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + "; torch.matmul of the "
        "product alone (f32, TF32 off; for reference, no port): " + ", ".join(
            f"{k} {v:.4f}" for k, v in mm.items())
        + f"; {_hmma_count('maxsim')}")
    return dict(name="maxsim", route="cuda",
                source="src/repro_torch/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim/kernel.py:42",
                **_launches("maxsim"), max_abs_err=max(errs),
                ms=times["synthetic"],
                plain_ms=_time_ms(lambda: maxsim(*cases["synthetic"],
                                                 impl="ref"), reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                f32_bound_ms=f32_bound, path_ms=times["flat path"],
                path_bound_ms=path_bound,
                parent_ms=times.get("synthetic parent"),
                parent_path_ms=times.get("flat path parent"),
                matmul_ms=mm["synthetic"], path_matmul_ms=mm["flat path"],
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL}, all-masked doc "
                      f"0 (Nq={Nq}, Lq={Lq} with 2 masked, Nd={d.shape[0]}, "
                      f"Ld={d.shape[1]}; and the flat path's own inputs"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: products at 3 passes of the TF32 rate "
                      f"(f32 bound {f32_bound:.4f} ms); library_ms "
                      f"{NO_LIBRARY}")


def _rerank_bound(q, qm, pair_dm, read_dm, n_slots):
    """Bytes: q and its mask, the doc masks read (``read_dm``) and their
    valid rows, 8 + 1 bytes a slot of ids and flags where the layout has
    them (``n_slots``), the scores; operations: 2 dim x valid query tokens
    x each query's valid candidate rows (``pair_dm`` [Nq, S, Ld]), three
    passes at the TF32 tensor-core rate."""
    dim = q.shape[2]
    n_bytes = (_nbytes(q, qm, read_dm) + int(read_dm.sum()) * dim * 4
               + n_slots * 9 + pair_dm.shape[0] * pair_dm.shape[1] * 4)
    ops = 2 * dim * int((qm.sum(1)[:, None] * pair_dm.sum(2)).sum())
    return _bound_ms(n_bytes, ops * TF32_PASSES, TF32_OPS_PER_S)


def check_maxsim_rerank(torch, dev, index, qv, recon_args, cascade_args,
                        parent):
    """The gathered entry at one slab of the recon store (S = 1,024 random
    candidates a query, 19 in 20 valid), and the indexed entry at the
    recon_rerank path's own slate (``recon_args``, one batch's arguments)
    and at the cascade's stage 2 (``cascade_args``), each held to its
    plain version. Where ``parent`` holds the parent design (the f32 FMA
    rerank of gathered candidates) it is held to the same limits and
    timed on the same inputs, at the slates with the gather it needs
    (``DocStore.gather``'s ``d[cand]``) inside its time."""
    from repro_torch.kernels.maxsim.ops import (maxsim_rerank,
                                                maxsim_rerank_indexed)
    store = index._plaid.recon_store()
    Nq, Lq, dim = qv.shape
    S = 1024
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    cand = torch.randint(0, index.n_docs, (Nq, S), generator=g, device=dev)
    cm = torch.rand((Nq, S), generator=g, device=dev) < 0.95
    d, dm = store.gather(cand)
    dm = dm & cm[:, :, None]
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False
    errs, times = [], {}

    def hold(what, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs.append(err)
        if not torch.allclose(got, want, rtol=1e-5, atol=SCORE_ATOL):
            raise AssertionError(f"maxsim_rerank {what}: max abs err {err}")

    syn = (qv, qm, d, dm)
    want = maxsim_rerank(*syn, impl="ref")
    hold("synthetic", maxsim_rerank(*syn), want)
    times["synthetic"] = _time_ms(lambda: maxsim_rerank(*syn))
    if parent:
        hold("synthetic, parent design", parent["maxsim_rerank"](*syn), want)
        times["synthetic parent"] = _time_ms(
            lambda: parent["maxsim_rerank"](*syn))
    slates, path = {}, {}
    for what, args in (("recon", recon_args), ("cascade", cascade_args)):
        pq, pqm, pd, pdm, pc, pcm = args
        want = maxsim_rerank_indexed(*args, impl="ref")
        hold(what, maxsim_rerank_indexed(*args), want)
        times[what] = _time_ms(lambda: maxsim_rerank_indexed(*args))
        if parent:
            def gathered():                   # the parent's way: gather, score
                c = torch.where(pcm, pc, torch.zeros_like(pc))
                return parent["maxsim_rerank"](pq, pqm, pd[c],
                                               pdm[c] & pcm[:, :, None])
            hold(f"{what}, parent design", gathered(), want)
            times[what + " parent (gather + kernel)"] = _time_ms(gathered)
        # the rows each query's valid candidates hold, and the distinct
        # candidates' (read once: the guide's bound) against all pairs'
        sdm = pdm[torch.where(pcm, pc, torch.zeros_like(pc))] & pcm[:, :, None]
        distinct = torch.unique(pc[pcm])
        path[what] = dict(
            ms=times[what],
            bound_ms=_rerank_bound(pq, pqm, sdm, pdm[distinct],
                                   pc.numel())[0],
            pairs_bound_ms=_rerank_bound(pq, pqm, sdm, sdm, pc.numel())[0],
            parent_ms=times.get(what + " parent (gather + kernel)"))
        slates[what] = (f"{what}: Nq={pq.shape[0]}, Lq={pq.shape[1]}, "
                        f"S={pc.shape[1]}, {int(pcm.sum())} valid candidates "
                        f"({distinct.numel()} distinct) of {pd.shape[0]} "
                        f"docs, Ld={pd.shape[1]}, {int(sdm.sum())} valid rows "
                        f"of all pairs, {int(pdm[distinct].sum())} of the "
                        f"distinct candidates; bound "
                        f"{path[what]['bound_ms']:.4f} ms (distinct rows "
                        f"read once), "
                        f"{path[what]['pairs_bound_ms']:.4f} ms (every "
                        f"pair's rows)")
    bound, by = _rerank_bound(qv, qm, dm, dm, 0)
    print("maxsim_rerank slates: " + "; ".join(slates.values()))
    print("maxsim_rerank times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items())
        + f"; {_hmma_count('maxsim', 'maxsim_tc_kernel')}")
    return dict(name="maxsim_rerank", route="cuda",
                source="src/repro_torch/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim/kernel.py:85",
                **_launches("maxsim_rerank"), max_abs_err=max(errs),
                ms=times["synthetic"],
                plain_ms=_time_ms(lambda: maxsim_rerank(*syn, impl="ref"),
                                  reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                parent_ms=times.get("synthetic parent"), slates_ms=path,
                times_ms=times,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL} (gathered: "
                      f"Nq={Nq}, Lq={Lq} with 2 masked, S={S}, "
                      f"Ld={d.shape[2]}; indexed: the recon_rerank and "
                      f"cascade slates"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: the valid rows read once, products at 3 "
                      f"passes of the TF32 rate; library_ms {NO_LIBRARY}")


def _assign_hold(what, torch, x, c, km, valid, got, want):
    """Ids equal to the plain version's except on rows whose top two sims
    lie within NEAR_TIE, best sims allclose rtol 1e-5 atol 1e-5;
    -> (rows that differ, valid near-tie rows, max abs err of best)."""
    got_a, got_s = got
    want_a, want_s = want
    sim = torch.bmm(x, c.transpose(1, 2)).masked_fill(~km[:, None, :],
                                                      float("-inf"))
    top2 = sim.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE
    differ = got_a != want_a
    n_near, n_differ = int((near & valid).sum()), int(differ.sum())
    bad = int((differ & ~near).sum())
    err = float((got_s - want_s).abs().max())
    print(f"kmeans_assign {what}: {n_differ} of {got_a.numel()} rows differ "
          f"from the plain version, {n_near} valid rows have their top two "
          f"sims within {NEAR_TIE}; rows that differ off a near tie: {bad}; "
          f"best max abs err {err:.3g}")
    if bad:
        raise AssertionError(f"kmeans_assign {what}: {bad} rows differ off a "
                             f"near tie")
    if not torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"kmeans_assign {what}: best sims max abs err "
                             f"{err}")
    return n_differ, n_near, err


def check_kmeans_assign(torch, dev, model, docs, parent):
    """At the k-means path's shapes: its first encode batch (B = 128,
    N = 256, d = 128) against its centroids after the last Lloyd step
    (K = 129), and at that shape on random unit vectors (the synthetic
    case). Timed at the path's inputs beside the parent design where
    ``parent`` holds it (whose ids and sims must be equal), and beside
    ``torch.matmul`` of the product alone (TF32 off; no port)."""
    from repro_torch.core.kmeans import kmeans_fit_batch
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    from repro_torch.models.colbert import encode_docs
    v, emit = encode_docs(model, docs[:ENCODE_BATCH])
    B, N, d = v.shape
    x, c, km = kmeans_fit_batch(v, emit, emit.sum(-1) // 2 + 1, N // 2 + 1)
    K = c.shape[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    xs = torch.randn((B, N, d), generator=g, device=dev)
    cs = torch.randn((B, K, d), generator=g, device=dev)
    xs, cs = xs / xs.norm(dim=-1, keepdim=True), cs / cs.norm(dim=-1,
                                                              keepdim=True)
    kms = torch.arange(K, device=dev)[None] < torch.randint(
        K // 2, K + 1, (B, 1), generator=g, device=dev)
    cases = {"path": (x, c, km, emit),
             "synthetic": (xs, cs, kms, torch.ones_like(emit))}
    held, errs, times = {}, [], {}
    for what, (xx, cc, kk, valid) in cases.items():
        want = kmeans_assign(xx, cc, kk, impl="ref")
        got = kmeans_assign(xx, cc, kk)
        n_differ, n_near, err = _assign_hold(what, torch, xx, cc, kk, valid,
                                             got, want)
        held[what] = f"{n_differ} differ, {n_near} valid near-tie rows"
        errs.append(err)
        times[what] = _time_ms(lambda: kmeans_assign(xx, cc, kk))
        if parent:
            pa, pb = parent["kmeans_assign"](xx, cc, kk)
            if not (torch.equal(pa, got[0]) and torch.equal(pb, got[1])):
                raise AssertionError(f"kmeans_assign {what}: differs from "
                                     f"the parent design's")
            times[what + " parent"] = _time_ms(
                lambda: parent["kmeans_assign"](xx, cc, kk))
    ct = c.transpose(1, 2)
    mm_ms = _time_ms(lambda: torch.matmul(x, ct))
    # bytes: x, the centroids and k_mask read once, ids and best written
    # once; operations: valid clusters only, three TF32 passes
    n_bytes = _nbytes(x, c, km) + B * N * 8
    ops = 2 * d * N * int(km.sum())
    bound, by = _bound_ms(n_bytes, ops * TF32_PASSES, TF32_OPS_PER_S)
    f32_bound = _bound_ms(n_bytes, ops)[0]
    print("kmeans_assign times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f"; torch.matmul of the "
        f"product alone (f32, TF32 off; for reference, no port) "
        f"{mm_ms:.4f}; bound {bound:.4f} ({by}; f32 {f32_bound:.4f}); "
        f"{_hmma_count('kmeans_assign')}")
    return dict(name="kmeans_assign", route="cuda",
                source="src/repro_torch/csrc/kmeans_assign.cu",
                replaces="src/repro/kernels/kmeans_assign/kernel.py:36",
                **_launches("kmeans_assign"), max_abs_err=max(errs),
                ms=times["path"],
                plain_ms=_time_ms(lambda: kmeans_assign(x, c, km,
                                                        impl="ref")),
                bound_ms=bound, bound_by=by, library_ms=None,
                f32_bound_ms=f32_bound, synthetic_ms=times["synthetic"],
                parent_ms=times.get("path parent"),
                parent_synthetic_ms=times.get("synthetic parent"),
                matmul_ms=mm_ms,
                check=f"ids equal off near ties, best allclose rtol 1e-5 "
                      f"atol 1e-5 at the path's first batch ({held['path']})"
                      f" and on random unit vectors ({held['synthetic']}) "
                      f"(B={B}, N={N}, K={K}, d={d}"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: x, centroids read once, products at 3 passes "
                      f"of the TF32 rate; library_ms null: a matmul plus a "
                      f"masked argmax is not one call")


def check_dequant_score(torch, dev, index, qv, parent):
    """On the main index's rows: the packed tokens of every candidate doc
    of the first query batch, scored against one query's tokens; held to
    the plain version and, per document, to ``maxsim_packed``. Where
    ``parent`` holds the parent design (f32 FMA) it is held to the same
    limits and timed on the same inputs."""
    from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
    from repro_torch.kernels.quant.ops import dequant_score
    p = index._plaid
    cand, cmask = index.candidates(qv)
    docs = torch.unique(cand[cmask])
    ids, words, tmask = p.padded_packed()
    dm = tmask[docs]
    w, cid = words[docs][dm].contiguous(), ids[docs][dm].contiguous()
    row_doc = torch.arange(len(docs), device=dev)[:, None].expand_as(dm)[dm]
    q = qv[0].contiguous()
    Lq, dim = q.shape
    M, bits = w.shape[0], p.codec.bits
    cen, vals = p.codec.centroids.contiguous(), p.codec.values.contiguous()
    args = (w, cid, cen, vals, q)
    got = dequant_score(*args, bits=bits)
    want = dequant_score(*args, bits=bits, impl="ref")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=0, atol=SCORE_ATOL):
        raise AssertionError(f"dequant_score: max abs err {err}")
    best = torch.full((len(docs), Lq), float("-inf"), device=dev)
    best = best.scatter_reduce(0, row_doc[:, None].expand(M, Lq), got,
                               "amax")
    qm = torch.ones((1, Lq), dtype=torch.bool, device=dev)
    packed = maxsim_packed_rerank(q[None], qm, words[docs][None],
                                  ids[docs][None], dm[None], cen, vals,
                                  bits=bits)[0]
    doc_err = float((best.sum(1) - packed).abs().max())
    if not torch.allclose(best.sum(1), packed, rtol=0, atol=SCORE_ATOL):
        raise AssertionError(f"dequant_score: per-doc MaxSim differs from "
                             f"maxsim_packed by {doc_err}")
    times = {"new": _time_ms(lambda: dequant_score(*args, bits=bits))}
    if parent:
        perr = float((parent["dequant_score"](*args, bits) - want).abs().max())
        if perr > SCORE_ATOL:
            raise AssertionError(f"dequant_score, parent design: max abs err "
                                 f"{perr}")
        times["parent"] = _time_ms(lambda: parent["dequant_score"](*args,
                                                                   bits))
    # operations: the products at 3 passes of the TF32 rate, the
    # reconstruction's ~4 dim a row at f32
    ops = [(M * 2 * Lq * dim * TF32_PASSES, TF32_OPS_PER_S)]
    out_bytes = M * Lq * 4
    bound, by = _bound_ms(_nbytes(*args) + out_bytes, M * 4 * dim,
                          more=ops)
    rows_bound, rows_by = _bound_ms(_nbytes(w, cid, vals, q) + M * dim * 4
                                    + out_bytes, M * 4 * dim, more=ops)
    print("dequant_score times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items())
        + f"; {_hmma_count('dequant_score')}")
    return dict(name="dequant_score", route="cuda",
                source="src/repro_torch/csrc/dequant_score.cu",
                replaces="src/repro/kernels/quant/kernel.py:62",
                **_launches("dequant_score"), max_abs_err=err,
                ms=times["new"],
                plain_ms=_time_ms(lambda: dequant_score(*args, bits=bits,
                                                        impl="ref")),
                bound_ms=bound, bound_by=by, library_ms=None,
                parent_ms=times.get("parent"),
                check=f"allclose atol {SCORE_ATOL}; per-doc max summed over "
                      f"the query equals maxsim_packed to {SCORE_ATOL} (max "
                      f"diff {doc_err:.3g}) (M={M} rows of {len(docs)} "
                      f"candidate docs, Lq={Lq}, dim={dim}, b={bits}"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: products at 3 passes of the TF32 rate, "
                      f"reconstruction at f32; with a centroid row read per "
                      f"row {rows_bound:.4f} ms ({rows_by}); launches 0: no "
                      f"path of the JAX package calls it; library_ms null: "
                      f"unpack + reconstruct + score is not one call")


def _errors(got, want):
    """Max abs and relative (Frobenius) error of got against want."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max()),
            float((got - want).norm() / want.norm()))


def _compare(what, got, want, atol, rel):
    """Prints the errors of got against want; raises past atol or rel."""
    err, r = _errors(got, want)
    print(f"{what}: max abs err {err:.4g} (atol {atol}), relative "
          f"{r:.4g} (limit {rel})")
    if err > atol or r > rel:
        raise AssertionError(f"{what}: the kernel path and the plain path "
                             f"disagree")


def _cache_errors(cache, want, S):
    """-> (max abs difference of layer 0's k and v, which no attention
    has touched; the largest relative error of one layer's k or v over
    the layers after it)."""
    first, worst = 0.0, 0.0
    for key in ("k", "v"):
        for layer in range(cache[key].shape[0]):
            err, r = _errors(cache[key][layer, :, :S], want[key][layer, :, :S])
            if layer == 0:
                first = max(first, err)
            else:
                worst = max(worst, r)
    return first, worst


@contextlib.contextmanager
def _flash_replaced(make):
    """The model's call of the ``flash_attention`` wrapper goes through
    ``make(wrapper)`` for the duration."""
    import repro_torch.models.attention as att
    inner = att.flash_attention
    att.flash_attention = make(inner)
    try:
        yield
    finally:
        att.flash_attention = inner


def _capturing(layers, store):
    """A replacement that passes every call through and keeps the q, k,
    v and output of the given layers' calls (in call order)."""
    def make(inner):
        calls = [0]

        def wrapped(q, k, v, **kw):
            o = inner(q, k, v, **kw)
            if calls[0] in layers:
                store[calls[0]] = (q, k, v, o)
            calls[0] += 1
            return o
        return wrapped
    return make


def _planted(fault):
    """A replacement that calls the kernel with one fault planted."""
    def make(inner):
        def wrapped(q, k, v, causal=True, **kw):
            if fault == "causal=False":
                return inner(q, k, v, causal=False, **kw)
            if fault == "kv head h % KV, not h // G":
                G = q.shape[1] // k.shape[1]
                return inner(q, k.repeat(1, G, 1, 1), v.repeat(1, G, 1, 1),
                             causal=causal, **kw)
            if fault == "diagonal off by one":   # row i sees columns < i
                return inner(q, k[:, :, :-1], v[:, :, :-1], causal=causal,
                             **kw)
            raise ValueError(fault)
        return wrapped
    return make


def _check_captured(what, torch, captured):
    """Each captured layer's kernel output against the plain version on
    the same q, k, v (the model's own, at the path's shape)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    tol = FLASH_TOL["bfloat16"]
    for layer, (q, k, v, o) in sorted(captured.items()):
        want = flash_attention(q, k, v, causal=True, impl="ref").float()
        err = float((o.float() - want).abs().max())
        FLASH_ERRS.append(err)
        print(f"{what}: layer {layer}'s own q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}: kernel vs plain version max abs err "
              f"{err:.4g} (atol = rtol = {tol})")
        if not torch.allclose(o.float(), want, rtol=tol, atol=tol):
            raise AssertionError(f"{what}: flash_attention disagrees with "
                                 f"its plain version at layer {layer}")
        del want


def _lm_model(rt, torch):
    cfg = dataclasses.replace(rt.get_config(LM_ARCH), use_flash_kernel=True)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{LM_ARCH}: compute dtype {cfg.dtype}")
    t0 = time.perf_counter()
    model = rt.init_transformer(cfg, seed=SEED)
    torch.cuda.synchronize()
    print(f"lm setup: {LM_ARCH} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"kv heads, d_head {cfg.d_head}, vocab {cfg.vocab_size}; "
          f"{sum(p.numel() for p in model.parameters())} params, random "
          f"from seed {SEED}) in {time.perf_counter() - t0:.3f}s")
    return cfg, model


def _serve(rt, torch, cfg, model, tokens, n_decode):
    """Prefill through the step builder, then ``n_decode`` greedy decode
    steps; -> (logits per position [n_decode + 1] x [B, V] f32, greedy
    tokens [B, n_decode + 1], cache, prefill s, decode s)."""
    from repro_torch.kernels import launch_counts
    B, S = tokens.shape
    prefill = rt.make_lm_prefill_step(cfg, max_len=S + n_decode)
    decode = rt.make_lm_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = launch_counts()["flash_attention"]
    out, toks = [logits.float()], [logits.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(n_decode):
        logits, cache = decode(model, cache, {"token": toks[-1][:, None],
                                              "pos": S + i})
        out.append(logits.float())
        toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if launch_counts()["flash_attention"] != after_prefill:
        raise AssertionError("a decode step launched flash_attention")
    return out, torch.stack(toks, 1), cache, prefill_s, decode_s


def _check_cache(what, cache, want, S):
    first, worst = _cache_errors(cache, want, S)
    print(f"{what} cache [:, :, :{S}]: layer 0 max abs difference {first:.4g}"
          f" (computed before any attention); layers 1.. largest relative "
          f"error of one layer's k or v {worst:.4g} (limit {LM_REL})")
    if worst > LM_REL:
        raise AssertionError(f"{what}: the kernel path's cache and the "
                             f"plain path's disagree")


def lm_faults(rt, torch, cfg, model, tokens, p_logits, p_cache):
    """The kernel path's prefill again with each of LM_FAULTS planted;
    each must break a limit that the lm path holds the kernel path to."""
    S = tokens.shape[1]
    for fault in LM_FAULTS:
        with _flash_replaced(_planted(fault)):
            logits, _, cache, _, _ = _serve(rt, torch, cfg, model, tokens, 0)
        err, r = _errors(logits[0], p_logits[0])
        _, worst = _cache_errors(cache, p_cache, S)
        del logits, cache
        caught = err > LM_LOGITS_ATOL or r > LM_REL or worst > LM_REL
        print(f"lm planted fault ({fault}): last-token logits max abs err "
              f"{err:.4g} (atol {LM_LOGITS_ATOL}), relative {r:.4g} (limit "
              f"{LM_REL}); cache layers 1.. largest relative {worst:.4g} "
              f"(limit {LM_REL}); caught: {caught}")
        if not caught:
            raise AssertionError(f"lm: the limits do not catch the planted "
                                 f"fault {fault!r}")


def lm_path(rt, torch, cfg, model):
    """Qwen3-0.6B serving: prefill of 8 x 2,048 tokens and 16 greedy
    decode steps through the kernel path, then the plain path."""
    from repro_torch.kernels import launch_counts
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    logits, toks, cache, prefill_s, decode_s = run_path(
        "lm", torch, lambda: _serve(rt, torch, cfg, model, tokens,
                                    LM_DECODE))
    peak = torch.cuda.max_memory_allocated()
    n = PATH_LAUNCHES["lm"]["flash_attention"]
    print(f"lm: flash_attention launches {n} (one a layer: "
          f"{n == cfg.n_layers}), none in the {LM_DECODE} decode steps")
    if n != cfg.n_layers:
        raise AssertionError(f"lm: {n} flash_attention launches, not "
                             f"{cfg.n_layers}")
    n_tok = LM_BATCH * LM_PROMPT
    print(f"lm: first pass prefill {prefill_s:.4f}s ({n_tok / prefill_s:.1f}"
          f" tokens/s), decode {decode_s / LM_DECODE * 1e3:.3f} ms a step "
          f"(batch {LM_BATCH}); peak device memory {peak} bytes")
    for x in logits:
        if tuple(x.shape) != (LM_BATCH, cfg.vocab_size) or not bool(
                torch.isfinite(x).all()):
            raise AssertionError("lm: logits of the wrong shape or not "
                                 "finite")
    # steady: the kernel path's prefill and decode again, keeping the
    # first and the last layer's kernel inputs and outputs
    captured = {}
    with _flash_replaced(_capturing((0, cfg.n_layers - 1), captured)):
        again, _, _, prefill_s, decode_s = _serve(rt, torch, cfg, model,
                                                  tokens, LM_DECODE)
    print(f"lm: steady prefill {prefill_s:.4f}s ({n_tok / prefill_s:.1f} "
          f"tokens/s), decode {decode_s / LM_DECODE * 1e3:.3f} ms a step")
    del again
    _check_captured("lm", torch, captured)
    del captured
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    before = launch_counts()["flash_attention"]
    p_logits, p_toks, p_cache, p_prefill_s, p_decode_s = _serve(
        rt, torch, plain, model, tokens, LM_DECODE)
    if launch_counts()["flash_attention"] != before:
        raise AssertionError("the plain path launched flash_attention")
    print(f"lm: plain path prefill {p_prefill_s:.4f}s "
          f"({n_tok / p_prefill_s:.1f} tokens/s), decode "
          f"{p_decode_s / LM_DECODE * 1e3:.3f} ms a step")
    _compare("lm last-token logits", logits[0], p_logits[0], LM_LOGITS_ATOL,
             LM_REL)
    _check_cache("lm", cache, p_cache, LM_PROMPT)
    _greedy_agree(logits, toks, p_logits, p_toks)
    del cache
    lm_faults(rt, torch, cfg, model, tokens, p_logits, p_cache)


def _greedy_agree(logits, toks, p_logits, p_toks):
    """Per sequence, positions up to the first differing token are fed
    the same tokens: their logits must agree to LM_LOGITS_ATOL and their
    tokens must be equal unless the plain path's top-2 gap is within
    LM_LOGITS_ATOL; after such a (legitimate) split the inputs differ
    and nothing more is compared."""
    B, n = toks.shape
    t, pt = toks.cpu().numpy(), p_toks.cpu().numpy()
    worst, splits = 0.0, []
    for b in range(B):
        for j in range(n):
            worst = max(worst, float((logits[j][b] - p_logits[j][b]).abs()
                                     .max()))
            if t[b, j] != pt[b, j]:
                top2 = p_logits[j][b].topk(2).values
                gap = float(top2[0] - top2[1])
                splits.append((b, j, gap))
                if gap > LM_LOGITS_ATOL:
                    raise AssertionError(
                        f"lm: greedy token {j} of sequence {b} differs "
                        f"where the plain path's top-2 gap is {gap:.4g}")
                break
    print(f"lm greedy decode: {B} sequences x {n} tokens; logits where the "
          f"inputs agree max abs err {worst:.4g} (atol {LM_LOGITS_ATOL}); "
          f"splits (sequence, token, plain top-2 gap): {splits}")
    if worst > LM_LOGITS_ATOL:
        raise AssertionError("lm: decode logits disagree")


def lm_long_path(rt, torch, cfg, model):
    """The same model at B = 1, S = 8,192, prefill only; the plain path
    there is the chunked online-softmax attention."""
    tokens = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, LM_LONG)).astype(np.int32)
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    if not (LM_LONG > plain.attn_full_threshold
            and LM_LONG % plain.attn_chunk == 0):
        raise AssertionError("lm_long: the plain path is not the chunked one")
    torch.cuda.reset_peak_memory_stats()
    logits, _, cache, prefill_s, _ = run_path(
        "lm_long", torch, lambda: _serve(rt, torch, cfg, model, tokens, 0))
    n = PATH_LAUNCHES["lm_long"]["flash_attention"]
    print(f"lm_long: flash_attention launches {n}; prefill {prefill_s:.4f}s "
          f"({LM_LONG / prefill_s:.1f} tokens/s); peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    if n != cfg.n_layers:
        raise AssertionError(f"lm_long: {n} flash_attention launches, not "
                             f"{cfg.n_layers}")
    captured = {}
    with _flash_replaced(_capturing((0, cfg.n_layers - 1), captured)):
        again = _serve(rt, torch, cfg, model, tokens, 0)
    del again
    _check_captured("lm_long", torch, captured)
    del captured
    p_logits, _, p_cache, p_prefill_s, _ = _serve(rt, torch, plain, model,
                                                  tokens, 0)
    print(f"lm_long: plain (chunked) path prefill {p_prefill_s:.4f}s")
    if not bool(torch.isfinite(logits[0]).all()):
        raise AssertionError("lm_long: non-finite logits")
    _compare("lm_long last-token logits", logits[0], p_logits[0],
             LM_LOGITS_ATOL, LM_REL)
    _check_cache("lm_long", cache, p_cache, LM_LONG)


def check_flash_attention(torch, dev):
    """The kernel against its plain version on seeded random inputs, then
    timed at the lm path's per-layer shape with the plain version and
    ``scaled_dot_product_attention`` (library_ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    errs = FLASH_ERRS
    for what, B, H, KV, Sq, Skv, dh, causal, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (rand((B, H, Sq, dh), dt), rand((B, KV, Skv, dh), dt),
                   rand((B, KV, Skv, dh), dt))
        got = flash_attention(q, k, v, causal=causal).float()
        want = flash_attention(q, k, v, causal=causal, impl="ref").float()
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        err = float((got - want).abs().max())
        errs.append(err)
        print(f"flash_attention {what} (B={B}, Sq={Sq}, Skv={Skv}, "
              f"{dtype}, causal={causal}): max abs err {err:.4g} (atol = "
              f"rtol = {tol})")
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {what}: disagrees")
        if causal and Sq > Skv:
            n0 = Sq - Skv
            if got[:, :, :n0].any() or want[:, :, :n0].any():
                raise AssertionError("flash_attention: rows that see no "
                                     "column are not 0")
            print(f"flash_attention {what}: the first {n0} rows are "
                  f"exactly 0 on both")
        del q, k, v, got, want
    # timed at the lm path's per-layer shape, in the model's layout (the
    # [B, S, heads, dh] projections seen as [B, heads, S, dh])
    B, H, KV, S, dh = LM_BATCH, 16, 8, LM_PROMPT, 64
    q, k, v = (rand((B, S, n, dh), torch.bfloat16).transpose(1, 2)
               for n in (H, KV, KV))
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
        kl, vl, gqa = k, v, dict(enable_gqa=True)
    except TypeError:                # no enable_gqa: repeat outside timing
        kl = k.repeat_interleave(H // KV, dim=1)
        vl = v.repeat_interleave(H // KV, dim=1)
        gqa = {}
    pairs = B * H * S * (S + 1) // 2
    flop = 4 * dh * pairs
    ms = _time_ms(lambda: flash_attention(q, k, v, causal=True), reps=20)
    plain_ms = _time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                impl="ref"))
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, kl, vl, is_causal=True, **gqa), reps=20)
    got = flash_attention(q, k, v, causal=True).float()
    want = flash_attention(q, k, v, causal=True, impl="ref").float()
    tol = FLASH_TOL["bfloat16"]
    errs.append(float((got - want).abs().max()))
    print(f"flash_attention timed lm shape (B={B}, S={S}, bf16, causal): "
          f"max abs err {errs[-1]:.4g} (atol = rtol = {tol})")
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError("flash_attention: disagrees at the lm shape")
    del got, want
    bound, by = _bound_ms(_nbytes(q, k, v) + q.numel() * q.element_size(),
                          flop, BF16_OPS_PER_S)
    print(f"flash_attention at the lm shape: {ms:.4f} ms, "
          f"{flop / ms / 1e9:.1f} TFLOP/s ({flop / 1e9:.2f} GFLOP of visible "
          f"pairs); scaled_dot_product_attention {library_ms:.4f} ms "
          f"({flop / library_ms / 1e9:.1f} TFLOP/s): "
          f"{ms / library_ms:.2f}x its time; {_hmma_count('flash_attention')}")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:91",
                **_launches("flash_attention"), max_abs_err=max(errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms,
                check=f"allclose atol = rtol {FLASH_TOL['float32']} (f32), "
                      f"{FLASH_TOL['bfloat16']} (bf16) in {len(FLASH_CASES)} "
                      f"cases ({', '.join(c[0] for c in FLASH_CASES)}), at "
                      f"the timed lm shape, and on the first and last "
                      f"layer's own q, k, v of the lm and lm_long paths; "
                      f"rows that see no column exactly 0; timed at q "
                      f"[{B * H}, {S}, {dh}], "
                      f"k/v [{B * KV}, {S}, {dh}] bf16 causal; bound: bf16 "
                      f"peak, 4 dh x {pairs} visible pairs; library_ms: "
                      f"scaled_dot_product_attention(is_causal=True"
                      f"{', enable_gqa=True' if gqa else ', k/v repeated'})")


def _hmma_count(name: str, kernel: str = "") -> str:
    """HMMA (tensor-core) instructions in the built library of
    ``csrc/<name>.cu``, by ``cuobjdump -sass``: in all, and in each of its
    functions whose (mangled) name holds ``kernel``; fails on none."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError(f"cuobjdump not found: the {name} library's "
                             f"HMMA instructions cannot be counted")
    sass = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    per_fn, fn = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif " HMMA." in line:
            per_fn[fn] = per_fn.get(fn, 0) + 1
    n = sum(per_fn.values())
    if n == 0:
        raise AssertionError(f"{name}: no HMMA instruction in its SASS")
    if not kernel:
        return f"SASS has {n} HMMA instructions (cuobjdump -sass)"
    each = {f: c for f, c in per_fn.items() if kernel in f}
    if not each:
        raise AssertionError(f"{name}: no HMMA instruction in {kernel}")
    return (f"SASS has {n} HMMA instructions (cuobjdump -sass), by "
            f"{kernel} instance: " + ", ".join(
                f"{f} {c}" for f, c in sorted(each.items())))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="",
                    help="a directory inside this checkout holding an "
                         "earlier checkout's src/repro_torch/csrc whose "
                         "kernels declare PARENT_ABI; timed beside this "
                         "one's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import repro_torch as rt
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    # f32 products and convolutions in full f32 (no TF32) everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    index, stats, model, docs, searcher, queries, S, I = main_path(rt, torch,
                                                                    dev)
    persist_path(rt, torch, model, queries, stats, S, I)
    facade_path(rt, torch, model, queries, S, I)
    host_probe_path(torch, index, searcher, queries, S, I)
    dense_path(rt, torch, model, docs, queries)
    flat_args, flat_index = flat_path(rt, torch, model, docs, queries)
    recon_args = recon_path(torch, index, searcher, queries, S, I)
    mutate_path(rt, torch, model, queries)
    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    hnsw_path(rt, torch, model, docs, queries)
    k8192_probe = plaid_k8192_path(rt, torch, model, flat_index, queries)
    del flat_index
    kmeans_path(rt, torch, model, docs, queries)
    sequential_path(rt, torch, model, docs, queries)
    cascade, cS, cI, cascade_args = cascade_path(rt, torch, model, docs,
                                                 queries)
    cascade_from_dir_path(rt, torch, model, queries, cascade, cS, cI)
    del cascade
    stream_path(rt, torch, model, docs, queries, card)
    stream_parity_path(rt, torch, model, docs, queries, card)
    gc.collect()                    # the sharded indexes go before the LM
    torch.cuda.empty_cache()
    lm_cfg, lm = _lm_model(rt, torch)
    lm_path(rt, torch, lm_cfg, lm)
    lm_long_path(rt, torch, lm_cfg, lm)
    del lm
    torch.cuda.empty_cache()

    parent = parent_kernels(args.parent)
    path_probe, path_packed, path_qv = capture_path_args(torch, searcher,
                                                         queries)
    split = search_split(torch, searcher, path_qv)
    index.packed_rerank = False
    recon_split = search_split(torch, searcher, path_qv, RECON_STAGES,
                               "recon_rerank")
    index.packed_rerank = True
    qv = searcher.encode_queries(queries[:QUERY_BATCH])
    kernels = [check_ward(torch, dev),
               check_plaid_probe(torch, dev, index, qv, path_probe,
                                 k8192_probe, parent),
               check_maxsim_packed(torch, dev, index, qv, path_packed, parent),
               check_maxsim(torch, dev, index, qv, flat_args, parent),
               check_maxsim_rerank(torch, dev, index, qv, recon_args,
                                   cascade_args, parent),
               check_kmeans_assign(torch, dev, model, docs, parent),
               check_dequant_score(torch, dev, index, qv, parent),
               check_flash_attention(torch, dev)]
    for k in kernels:
        lib = (f", library {k['library_ms']:.4f} ms" if k["library_ms"]
               is not None else "")
        print(f"kernel {k['name']}: {k.pop('check')}; {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms{lib}, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']})")

    _agree("main path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))

    print(json.dumps({"kernels": kernels, "search_split_ms": split,
                      "recon_split_ms": recon_split}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
