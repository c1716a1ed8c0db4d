#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; no network

1. Builds the four CUDA sources from ``src/repro_torch/csrc`` with
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
     results equal the packed path's tie-aware, scores to 1e-4.
   The dense and flat paths are re-run with the plain versions
   (``impl="ref"``) and must agree.
3. Holds each kernel against its plain PyTorch version at its path's
   shapes (inputs taken from the built indexes), and times both with
   CUDA events; prints each kernel's bound (bytes over 3.35 TB/s or
   operations over the f32 peak of 67 TFLOP/s, the larger).
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
ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT_DIR = os.path.join(ROOT, "build", "chip_smoke_index")
# kernels each path must launch
PATH_KERNELS = {
    "main": ("ward_pool", "plaid_probe", "maxsim_packed"),
    "from_dir": ("plaid_probe", "maxsim_packed"),
    "host_probe": ("plaid_probe", "maxsim_packed"),
    "dense": ("ward_pool", "maxsim"),
    "flat": ("ward_pool", "maxsim"),
    "recon_rerank": ("plaid_probe", "maxsim_rerank"),
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

    qv = searcher.encode_queries(queries[:QUERY_BATCH])
    kernels = [check_ward(torch, dev), check_plaid_probe(torch, dev, index, qv),
               check_maxsim_packed(torch, dev, index, qv),
               check_maxsim(torch, dev, index, qv),
               check_maxsim_rerank(torch, dev, index, qv)]
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
