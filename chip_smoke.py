#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; no network

1. Builds the three CUDA kernels from ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, started together).
2. Drives the main path once through the user entry points, with every
   kernel's launch counter at 0 before and read after: full-width
   ColBERTv2 (random weights from a seed), a 16,384-doc synthetic
   corpus, ``Indexer.build`` with Ward pooling at factor 2 on the default
   PLAID index (K = 256, 2 bits, nprobe 8, t_cs 0.3) with ``ndocs`` at
   1024, PLAID's own k = 100 setting, then ``Searcher.search`` on 64
   queries in two batches of 32 (k = 10). Fails unless every kernel
   launched. With random weights each document's vectors crowd into one
   or two centroids, so a query's candidate set is ~6-9% of the corpus
   (measured: 216-1489 of 16,384): under the default ndocs = 8192 the
   approximate-score prune — the ``plaid_probe`` kernel — would never
   run.
3. Holds each kernel against its plain PyTorch version at the main
   path's shapes (inputs taken from the built index), and times both
   with CUDA events; prints each kernel's bound (bytes over 3.35 TB/s or
   operations over the f32 peak of 67 TFLOP/s, the larger).
4. Re-runs the search with the plain versions (``impl="ref"``): the ids
   must agree tie-aware and the scores to 1e-4.

The line before the last holds ``nvidia-smi``'s card name and power
limit; the one before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing that line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_OPS_PER_S = 67e12              # H100 SXM f32, outside the tensor cores
N_DOCS = 16384
N_QUERIES = 64
QUERY_BATCH = 32
TOP_K = 10
NDOCS = 1024                       # PLAID's k=100 setting: engages the prune
SEED = 0
SCORE_ATOL = 1e-4                  # f32 sums in another order


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


def main_path(rt, torch, dev):
    """Build and search through the entry points; returns what the kernel
    checks and the plain re-run need."""
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    from repro_torch.kernels import launch_counts, reset_launch_counts

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

    reset_launch_counts()
    t0 = time.perf_counter()
    indexer = rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                         pooling_spec=rt.PoolingSpec("ward", 2),
                         encode_batch=128, device=dev)
    index, stats = indexer.build(docs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
    t0 = time.perf_counter()
    results = [searcher.search(queries[lo:lo + QUERY_BATCH], k=TOP_K)
               for lo in range(0, N_QUERIES, QUERY_BATCH)]
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = launch_counts()
    print(f"main path launches: {launches}")
    _candidate_report(torch, index, searcher.encode_queries(queries))
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    S = np.concatenate([r[0] for r in results])
    I = np.concatenate([r[1] for r in results])
    print(f"build: {stats.n_docs} docs in {build_s:.3f}s "
          f"({stats.n_docs / build_s:.1f} docs/s); stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in stats.stage_seconds.items()))
    print(f"vectors: raw {stats.n_vectors_raw}, stored "
          f"{stats.n_vectors_stored} (reduction "
          f"{stats.vector_reduction:.4f}); device bytes {stats.device_bytes}")
    if stats.n_vectors_stored > stats.n_vectors_raw / 2 + stats.n_docs:
        raise AssertionError("Ward f=2 stored more than raw/2 + n_docs")
    if S.shape != (N_QUERIES, TOP_K) or I.shape != (N_QUERIES, TOP_K):
        raise AssertionError(f"result shapes {S.shape} {I.shape}")
    if not np.isfinite(S).all():
        raise AssertionError("non-finite scores in the results")
    if not ((I >= 0) & (I < stats.n_docs)).all():
        raise AssertionError("invalid doc ids in the results")

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
    return index, searcher, queries, S, I, launches


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


def check_ward(torch, dev, launches):
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
                launches=launches["ward_pool"], max_abs_err=0.0,
                ms=_time_ms(lambda: ward_assign(x, mask, f)),
                plain_ms=_time_ms(lambda: ward_assign(x, mask, f, impl="ref"),
                                  reps=1),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"assignments equal in all {B} docs "
                      f"(B={B}, N={N}, d={d}, f={f})")


def check_plaid_probe(torch, dev, index, qv, launches):
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
                launches=launches["plaid_probe"], max_abs_err=err,
                ms=_time_ms(lambda: plaid_probe_scores(*args, t_cs=index.t_cs)),
                plain_ms=_time_ms(lambda: plaid_probe_scores(
                    *args, t_cs=index.t_cs, impl="ref"), reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"-inf slots equal, finite allclose rtol 1e-5 atol "
                      f"{SCORE_ATOL} (Nq={Nq}, Lq={Lq}, C={C}, L={L}, K={K})")


def check_maxsim_packed(torch, dev, index, qv, launches):
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
                launches=launches["maxsim_packed"], max_abs_err=max(errs),
                ms=got_ms, plain_ms=plain_ms, bound_ms=bounds[0],
                bound_by=bounds[1], library_ms=None,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL} at "
                      f"{', '.join(records)} (Nq={Nq}, S={S}, "
                      f"Ld={ids.shape[1]}); timed at b={p.codec.bits}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import repro_torch as rt
    from repro_torch.core.maxsim import tie_aware_mismatches
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

    index, searcher, queries, S, I, launches = main_path(rt, torch, dev)
    qv = searcher.encode_queries(queries[:QUERY_BATCH])
    kernels = [check_ward(torch, dev, launches),
               check_plaid_probe(torch, dev, index, qv, launches),
               check_maxsim_packed(torch, dev, index, qv, launches)]
    for k in kernels:
        print(f"kernel {k['name']}: {k.pop('check')}; {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")

    ref = [searcher.search(queries[lo:lo + QUERY_BATCH], k=TOP_K, impl="ref")
           for lo in range(0, N_QUERIES, QUERY_BATCH)]
    S1 = np.concatenate([r[0] for r in ref])
    I1 = np.concatenate([r[1] for r in ref])
    bad = tie_aware_mismatches(I, S, I1, S1, SCORE_ATOL)
    same = float((I == I1).mean())
    print(f"plain-version search: ids equal {same:.4f}, tie-aware "
          f"mismatches {bad}, max score diff {np.abs(S - S1).max():.3g}")
    if bad or not np.allclose(S, S1, rtol=1e-5, atol=SCORE_ATOL):
        raise AssertionError("search with kernels disagrees with the plain "
                             "versions")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
