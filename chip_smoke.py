#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; no network

1. Builds the six CUDA sources from ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, started together).
2. Drives each path through the user entry points, every kernel's launch
   counter set to 0 just before the path and read just after; a path
   fails unless each of its kernels launched:
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
     (the ``maxsim_rerank`` kernel over the f32 reconstruction store);
     results equal the packed path's tie-aware, scores to 1e-4;
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
     (``ward_pool``, ``maxsim`` for stage 1, ``maxsim_rerank`` for
     stage 2);
   * cascade_from_dir: the cascade saved and served by
     ``Searcher.from_dir``; results equal the in-memory cascade's
     exactly.
   The dense, flat, kmeans and cascade paths are re-run with the plain
   versions (``impl="ref"``) and must agree.
3. Holds each kernel against its plain PyTorch version at its path's
   shapes (inputs taken from the built indexes and the k-means path's
   first encode batch), and times both with CUDA events; prints each
   kernel's bound (bytes over 3.35 TB/s or operations over the f32 peak
   of 67 TFLOP/s, the larger).
4. Re-runs the main search with the plain versions (``impl="ref"``): the
   ids must agree tie-aware and the scores to 1e-4.

The line before the last holds ``nvidia-smi``'s card name and power
limit; the one before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing that line.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_OPS_PER_S = 67e12              # H100 SXM f32, outside the tensor cores
N_DOCS = 16384
N_QUERIES = 64
QUERY_BATCH = 32
QUERY_LEN = 32                     # ColBERTv2 query_maxlen
TOP_K = 10
NDOCS = 1024                       # PLAID's k=100 setting: engages the prune
SEED = 0
SCORE_ATOL = 1e-4                  # f32 sums in another order
DENSE_DOCS = 512
FLAT_DOCS = 4096
KMEANS_DOCS = 4096
KMEANS_NDOCS = 256                 # PLAID's k=10 setting (see the docstring)
SEQUENTIAL_DOCS = 1024
CASCADE_DOCS = 4096
ENCODE_BATCH = 128
NEAR_TIE = 1e-5                    # kmeans_assign: top-two sims this close
ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT_DIR = os.path.join(ROOT, "build", "chip_smoke_index")
CASCADE_DIR = os.path.join(ROOT, "build", "chip_smoke_cascade")
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
}
PATH_LAUNCHES = {}
NO_LIBRARY = ("null: no single PyTorch call does the masked max over doc "
              "tokens and the masked sum over query tokens")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    """Mean ms per call on the card: CUDA events around ``reps`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_path(name, torch, fn):
    """Drive one path with every launch counter at 0 just before it and
    read just after; fails unless each of the path's kernels launched."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = launch_counts()
    PATH_LAUNCHES[name] = launches
    print(f"{name} path launches: {launches}")
    missing = [k for k in PATH_KERNELS[name] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {name} path: "
                             f"{missing}")
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
    diff = float(np.abs(S - S1).max())
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
    return index, stats, model, docs, searcher, queries, S, I


def _candidate_report(torch, index, qv):
    """Per-query candidate counts of stage 2 (the prune engages when a
    batch's largest count pads past ``ndocs``)."""
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


def check_ward(torch, dev):
    from repro_torch.core.ward import ward_targets
    from repro_torch.kernels.ward_pool.ops import ward_assign
    B, N, d, f = 64, 256, 128, 2
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((B, N, d), generator=g, device=dev)
    n_valid = torch.randint(N // 2, N + 1, (B,), generator=g, device=dev)
    mask = torch.arange(N, device=dev)[None, :] < n_valid[:, None]
    got = ward_assign(x, mask, f)
    want = ward_assign(x, mask, f, impl="ref")
    torch.cuda.synchronize()
    bad = int((got != want).any(dim=1).sum())
    if bad:
        raise AssertionError(f"ward_pool: {bad}/{B} docs differ from the "
                             f"plain version")
    _, steps = ward_targets(mask, f)
    n_steps = int(steps.sum())
    P = N * (N - 1) // 2
    # Gram (upper triangle) + per merge: argmin scan and Lance-Williams row
    ops = B * P * d * 2 + n_steps * (P + 10 * N)
    bound, by = _bound_ms(_nbytes(x, mask) + B * N * 4, ops)
    return dict(name="ward_pool", route="cuda",
                source="src/repro_torch/csrc/ward_pool.cu",
                replaces="src/repro/kernels/ward_pool/kernel.py:63",
                **_launches("ward_pool"), max_abs_err=0.0,
                ms=_time_ms(lambda: ward_assign(x, mask, f)),
                plain_ms=_time_ms(lambda: ward_assign(x, mask, f, impl="ref"),
                                  reps=1),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"assignments equal in all {B} docs "
                      f"(B={B}, N={N}, d={d}, f={f})")


def check_plaid_probe(torch, dev, index, qv):
    from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores
    p = index._plaid
    codes, tok_mask = p.padded_codes()
    Nq, Lq, _ = qv.shape
    C = p.n_docs
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cand = torch.stack([torch.randperm(C, generator=g, device=dev)
                        for _ in range(Nq)])
    cmask = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False                       # masked query tokens too
    gcodes = codes[cand]
    gmask = tok_mask[cand] & cmask[:, :, None]
    cen = p.codec.centroids.contiguous()
    args = (qv, qm, cen, gcodes, gmask, cmask)
    got = plaid_probe_scores(*args, t_cs=index.t_cs)
    want = plaid_probe_scores(*args, t_cs=index.t_cs, impl="ref")
    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("plaid_probe: -inf slots differ")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    if not torch.allclose(got[fin], want[fin], rtol=1e-5, atol=SCORE_ATOL):
        raise AssertionError(f"plaid_probe: max abs err {err}")
    K, dim = cen.shape
    L = gcodes.shape[2]
    ops = Nq * Lq * K * dim * 2 + int(gmask.sum()) * Lq * 2
    bound, by = _bound_ms(_nbytes(qv, qm, cen, gcodes, gmask, cmask)
                          + Nq * C * 4, ops)
    return dict(name="plaid_probe", route="cuda",
                source="src/repro_torch/csrc/plaid_probe.cu",
                replaces="src/repro/kernels/plaid_probe/kernel.py:62",
                **_launches("plaid_probe"), max_abs_err=err,
                ms=_time_ms(lambda: plaid_probe_scores(*args, t_cs=index.t_cs)),
                plain_ms=_time_ms(lambda: plaid_probe_scores(
                    *args, t_cs=index.t_cs, impl="ref"), reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"-inf slots equal, finite allclose rtol 1e-5 atol "
                      f"{SCORE_ATOL} (Nq={Nq}, Lq={Lq}, C={C}, L={L}, K={K})")


def check_maxsim_packed(torch, dev, index, qv):
    from repro_torch.core.quantization import ResidualCodec
    from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
    p = index._plaid
    ids, words, tmask = p.padded_packed()
    Nq, Lq, dim = qv.shape
    S = 1024
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    cand = torch.randint(0, p.n_docs, (Nq, S), generator=g, device=dev)
    cm = torch.rand((Nq, S), generator=g, device=dev) < 0.95
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    records, errs, got_ms, plain_ms, bounds = [], [], 0.0, 0.0, []
    for bits in (2, 4):
        if bits == p.codec.bits:
            w, cen, vals = words[cand], p.codec.centroids, p.codec.values
        else:                                # random codes of the other width
            W = dim * bits // 32
            w = torch.randint(-2 ** 31, 2 ** 31 - 1, (Nq, S, ids.shape[1], W),
                              generator=g, device=dev, dtype=torch.int32)
            cen = p.codec.centroids
            vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.05
        a = ids[cand]
        dm = tmask[cand] & cm[:, :, None]
        args = (qv, qm, w, a, dm, cen.contiguous(), vals.contiguous())
        got = maxsim_packed_rerank(*args, bits=bits)
        want = maxsim_packed_rerank(*args, bits=bits, impl="ref")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=SCORE_ATOL):
            raise AssertionError(f"maxsim_packed b={bits}: max abs err {err}")
        errs.append(err)
        if bits == p.codec.bits:
            got_ms = _time_ms(lambda: maxsim_packed_rerank(*args, bits=bits))
            plain_ms = _time_ms(lambda: maxsim_packed_rerank(
                *args, bits=bits, impl="ref"), reps=2)
            n_tok = int(dm.sum())
            ops = n_tok * (Lq * dim * 2 + dim * 4)
            bounds = _bound_ms(_nbytes(*args) + Nq * S * 4, ops)
        records.append(f"b={bits} W={w.shape[-1]}")
    return dict(name="maxsim_packed", route="cuda",
                source="src/repro_torch/csrc/maxsim_packed.cu",
                replaces="src/repro/kernels/maxsim_packed/kernel.py:66",
                **_launches("maxsim_packed"), max_abs_err=max(errs),
                ms=got_ms, plain_ms=plain_ms, bound_ms=bounds[0],
                bound_by=bounds[1], library_ms=None,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL} at "
                      f"{', '.join(records)} (Nq={Nq}, S={S}, "
                      f"Ld={ids.shape[1]}); timed at b={p.codec.bits}")


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
    return index


def recon_path(torch, index, searcher, queries, S, I):
    """The main index reranked from the f32 reconstruction store."""
    index.packed_rerank = False
    S1, I1 = run_path("recon_rerank", torch,
                      lambda: _search_all(searcher, queries))
    recon_s = _steady_search_s(torch, searcher,
                               searcher.encode_queries(queries))
    index.packed_rerank = True
    print(f"recon rerank: store {index._plaid.recon.device_nbytes()} device "
          f"bytes; index search {N_QUERIES} queries steady {recon_s:.4f}s")
    _agree("recon rerank vs packed rerank", S, I, S1, I1)


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
    return cascade, S, I


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


def _launches(name):
    by_path = {p: c[name] for p, c in PATH_LAUNCHES.items() if c[name]}
    return dict(launches=sum(by_path.values()), launches_by_path=by_path)


def check_maxsim(torch, dev, index, qv):
    """All-pairs kernel at the recon store's full width (Nd = 16,384)."""
    from repro_torch.kernels.maxsim.ops import maxsim
    d, dm = index._plaid.recon_store().padded()
    dm = dm.clone()
    dm[0] = False                                # an all-masked doc
    Nq, Lq, dim = qv.shape
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False                           # masked query tokens
    got = maxsim(qv, qm, d, dm)
    want = maxsim(qv, qm, d, dm, impl="ref")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=SCORE_ATOL):
        raise AssertionError(f"maxsim: max abs err {err}")
    if float(got[:, 0].abs().max()) != 0.0:
        raise AssertionError("maxsim: the all-masked doc did not score 0")
    ops = 2 * dim * int(qm.sum()) * int(dm.sum())
    bound, by = _bound_ms(_nbytes(qv, qm, d, dm) + got.numel() * 4, ops)
    return dict(name="maxsim", route="cuda",
                source="src/repro_torch/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim/kernel.py:42",
                **_launches("maxsim"), max_abs_err=err,
                ms=_time_ms(lambda: maxsim(qv, qm, d, dm)),
                plain_ms=_time_ms(lambda: maxsim(qv, qm, d, dm, impl="ref"),
                                  reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL}, all-masked doc "
                      f"0 (Nq={Nq}, Lq={Lq} with 2 masked, Nd={d.shape[0]}, "
                      f"Ld={d.shape[1]}); library_ms {NO_LIBRARY}")


def check_maxsim_rerank(torch, dev, index, qv):
    """Per-query rerank at one slab of the main path (S = 1024)."""
    from repro_torch.kernels.maxsim.ops import maxsim_rerank
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
    got = maxsim_rerank(qv, qm, d, dm)
    want = maxsim_rerank(qv, qm, d, dm, impl="ref")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=SCORE_ATOL):
        raise AssertionError(f"maxsim_rerank: max abs err {err}")
    ops = 2 * dim * int((qm.sum(1)[:, None] * dm.sum(2)).sum())
    bound, by = _bound_ms(_nbytes(qv, qm, d, dm) + got.numel() * 4, ops)
    return dict(name="maxsim_rerank", route="cuda",
                source="src/repro_torch/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim/kernel.py:85",
                **_launches("maxsim_rerank"), max_abs_err=err,
                ms=_time_ms(lambda: maxsim_rerank(qv, qm, d, dm)),
                plain_ms=_time_ms(lambda: maxsim_rerank(qv, qm, d, dm,
                                                        impl="ref"), reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL} (Nq={Nq}, "
                      f"Lq={Lq} with 2 masked, S={S}, Ld={d.shape[2]}); "
                      f"library_ms {NO_LIBRARY}")


def check_kmeans_assign(torch, dev, model, docs):
    """At the k-means path's shapes: its first encode batch (B = 128,
    N = 256, d = 128) against its centroids after the last Lloyd step
    (K = 129). Ids must equal the plain version's except on rows whose
    top two sims lie within NEAR_TIE (their count is printed)."""
    from repro_torch.core.kmeans import kmeans_fit_batch
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    from repro_torch.models.colbert import encode_docs
    v, emit = encode_docs(model, docs[:ENCODE_BATCH])
    B, N, d = v.shape
    x, c, km = kmeans_fit_batch(v, emit, emit.sum(-1) // 2 + 1, N // 2 + 1)
    K = c.shape[1]
    got_a, got_s = kmeans_assign(x, c, km)
    want_a, want_s = kmeans_assign(x, c, km, impl="ref")
    torch.cuda.synchronize()
    sim = torch.bmm(x, c.transpose(1, 2)).masked_fill(~km[:, None, :],
                                                      float("-inf"))
    top2 = sim.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE
    differ = got_a != want_a
    n_near, n_differ = int((near & emit).sum()), int(differ.sum())
    bad = int((differ & ~near).sum())
    err = float((got_s - want_s).abs().max())
    print(f"kmeans_assign: {n_differ} of {B * N} rows differ from the plain "
          f"version, all on near-tie rows: {bad == 0}; {n_near} valid rows "
          f"have their top two sims within {NEAR_TIE}")
    if bad:
        raise AssertionError(f"kmeans_assign: {bad} rows differ off a "
                             f"near tie")
    if not torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"kmeans_assign: best sims max abs err {err}")
    ops = 2 * d * N * int(km.sum())            # valid clusters only
    bound, by = _bound_ms(_nbytes(x, c, km) + B * N * 8, ops)
    return dict(name="kmeans_assign", route="cuda",
                source="src/repro_torch/csrc/kmeans_assign.cu",
                replaces="src/repro/kernels/kmeans_assign/kernel.py:36",
                **_launches("kmeans_assign"), max_abs_err=err,
                ms=_time_ms(lambda: kmeans_assign(x, c, km)),
                plain_ms=_time_ms(lambda: kmeans_assign(x, c, km,
                                                        impl="ref")),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"ids equal off near ties ({n_differ} differ, {n_near}"
                      f" valid near-tie rows), best allclose rtol 1e-5 atol "
                      f"1e-5 (B={B}, N={N}, K={K}, d={d}); library_ms null: "
                      f"a matmul plus a masked argmax is not one call")


def check_dequant_score(torch, dev, index, qv):
    """On the main index's rows: the packed tokens of every candidate doc
    of the first query batch, scored against one query's tokens."""
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
    ops = M * (2 * Lq * dim + 4 * dim)
    out_bytes = M * Lq * 4
    bound, by = _bound_ms(_nbytes(*args) + out_bytes, ops)
    rows_bound, rows_by = _bound_ms(_nbytes(w, cid, vals, q) + M * dim * 4
                                    + out_bytes, ops)
    return dict(name="dequant_score", route="cuda",
                source="src/repro_torch/csrc/dequant_score.cu",
                replaces="src/repro/kernels/quant/kernel.py:62",
                **_launches("dequant_score"), max_abs_err=err,
                ms=_time_ms(lambda: dequant_score(*args, bits=bits)),
                plain_ms=_time_ms(lambda: dequant_score(*args, bits=bits,
                                                        impl="ref")),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"allclose atol {SCORE_ATOL}; per-doc max summed over "
                      f"the query equals maxsim_packed to {SCORE_ATOL} (max "
                      f"diff {doc_err:.3g}) (M={M} rows of {len(docs)} "
                      f"candidate docs, Lq={Lq}, dim={dim}, b={bits}); bound "
                      f"with a centroid row read per row {rows_bound:.4f} ms "
                      f"({rows_by}); launches 0: no path of the JAX package "
                      f"calls it; library_ms null: unpack + reconstruct + "
                      f"score is not one call")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import repro_torch as rt
    from repro_torch.kernels import build

    dev = torch.device("cuda")
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
    host_probe_path(torch, index, searcher, queries, S, I)
    dense_path(rt, torch, model, docs, queries)
    flat_path(rt, torch, model, docs, queries)
    recon_path(torch, index, searcher, queries, S, I)
    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    kmeans_path(rt, torch, model, docs, queries)
    sequential_path(rt, torch, model, docs, queries)
    cascade, cS, cI = cascade_path(rt, torch, model, docs, queries)
    cascade_from_dir_path(rt, torch, model, queries, cascade, cS, cI)

    qv = searcher.encode_queries(queries[:QUERY_BATCH])
    kernels = [check_ward(torch, dev), check_plaid_probe(torch, dev, index, qv),
               check_maxsim_packed(torch, dev, index, qv),
               check_maxsim(torch, dev, index, qv),
               check_maxsim_rerank(torch, dev, index, qv),
               check_kmeans_assign(torch, dev, model, docs),
               check_dequant_score(torch, dev, index, qv)]
    for k in kernels:
        print(f"kernel {k['name']}: {k.pop('check')}; {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")

    _agree("main path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
