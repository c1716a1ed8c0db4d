"""The port's serving runtime (``repro_torch/launch/engine.py``,
``core/replicated.py``, ``launch/serve.py``, ``Retriever.serve``) on the
CPU, after ``tests/test_serving_engine.py`` and
``tests/test_replicated.py``.

* Shape buckets, futures, coalescing and each flush reason (full,
  deadline, k_switch, drain), requests that span microbatches.
* ``stop`` with and without drain, and a failing index's error reaching
  every future of its batch.
* ``swap_index`` in flight and a watched-directory swap, with no failed
  request.
* ``ReplicatedIndex`` lanes against the port's direct search and the JAX
  package's direct search on the same artifact.
* ``run_open_loop`` with a fixed seed; ``Retriever.serve`` with the
  SMOKE encoder and 4 submitter threads; the serve CLI.

The parity contract: every request against a direct search of the same
queries, ids tie-aware and scores within 1e-4 (``SCORE_ATOL``), and
bitwise where it is measured so: the index tests encode nothing (the
queries are vectors) and are bitwise on the CPU; through the SMOKE
encoder the searcher encodes every chunk at one width, so requests are
bitwise there too (``chip_smoke.py``'s serve path counts the bitwise
share on the card). A request in flight across a swap is held to the
contract only. Every wait is bounded (``result(timeout=...)``,
``join(timeout=...)``), and no assertion depends on wall-clock speed.
"""
import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.core.persist import save_index
from repro_torch.core.replicated import ReplicatedIndex, serve_device_table
from repro_torch.core.sharded import ShardedIndex
from repro_torch.launch.engine import (CompileCounter, IndexHandle,
                                       SearchFuture, ServingEngine,
                                       bucket_for, run_open_loop,
                                       shape_buckets)

DIM, LQ = 16, 5
SCORE_ATOL = 1e-4
WAIT = 60.0                     # bound of every wait, seconds


def _unit_docs(rng, n=40, lo=4, hi=20):
    docs = []
    for _ in range(n):
        v = rng.normal(size=(rng.integers(lo, hi), DIM)).astype(np.float32)
        docs.append(torch.from_numpy(
            v / np.linalg.norm(v, axis=-1, keepdims=True)))
    return docs


def _queries(rng, n):
    q = rng.normal(size=(n, LQ, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _index(backend="flat", n_docs=40, seed=0, sharded=False):
    """Exhaustive candidate budgets: stage 1 never prunes."""
    docs = _unit_docs(np.random.default_rng(seed), n=n_docs)
    kw = dict(doc_maxlen=24, n_centroids=8, nprobe=8, ndocs=4096,
              hnsw_candidates=4096, device="cpu")
    idx = (ShardedIndex(dim=DIM, backend=backend,
                        shard_max_vectors=(n_docs // 3) * 12, **kw)
           if sharded else MultiVectorIndex(dim=DIM, backend=backend, **kw))
    idx.add(docs)
    return idx


class VecSearcher:
    """The engine's two stages with an identity encoder: the 'tokens' are
    query vectors already, so coalescing, padding and swaps are tested
    apart from the encoder."""

    def __init__(self, index):
        self.index = index

    def encode_queries(self, q):
        return torch.as_tensor(np.asarray(q, np.float32))

    def warmup(self, batch_sizes, k=10):
        for bs in sorted(set(batch_sizes)):
            self.index.search_batch(torch.zeros((bs, LQ, DIM)), k=k)


def _engine(index, **kw):
    kw.setdefault("max_wait_ms", 1.0)
    return ServingEngine(VecSearcher(index), device="cpu", **kw)


def _held(S, I, S_ref, I_ref):
    """The parity contract: ids tie-aware, scores within SCORE_ATOL."""
    S, I = np.asarray(S), np.asarray(I)
    assert tie_aware_mismatches(np.asarray(I_ref), np.asarray(S_ref), I, S,
                                SCORE_ATOL) == 0
    np.testing.assert_allclose(S, S_ref, rtol=0, atol=SCORE_ATOL)


# ---------------------------------------------------------------- buckets
def test_shape_buckets_and_futures():
    assert shape_buckets(1) == [1]
    assert shape_buckets(8) == [1, 2, 4, 8]
    assert shape_buckets(12) == [1, 2, 4, 8, 12]
    assert bucket_for(3, shape_buckets(8)) == 4
    assert bucket_for(8, shape_buckets(8)) == 8
    with pytest.raises(ValueError):
        bucket_for(9, shape_buckets(8))
    fut = SearchFuture(3, 2, submit_t=time.perf_counter())
    assert not fut.done()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    fut._fill(0, np.ones((2, 2), np.float32), np.zeros((2, 2), np.int64))
    assert not fut.done()                       # one row still missing
    fut._fill(2, np.ones((1, 2), np.float32), np.ones((1, 2), np.int64))
    S, I = fut.result(timeout=WAIT)
    assert S.shape == I.shape == (3, 2) and I[2].tolist() == [1, 1]
    assert fut.latency_s >= 0
    bad = SearchFuture(1, 2, submit_t=time.perf_counter())
    bad._fail(KeyError("boom"))
    with pytest.raises(KeyError):
        bad.result(timeout=WAIT)


def test_index_handle_drains_before_retire():
    retired = []
    h = IndexHandle("idx", generation=1, on_retire=retired.append)
    h.acquire()
    h.acquire()
    h.retire()
    assert not retired
    h.release()
    assert not retired
    h.release()
    assert retired == [h]
    assert h.wait_drained(0.1)


# ------------------------------------------------------------- coalescing
@pytest.mark.parametrize("backend", ["flat", "hnsw", "plaid"])
@pytest.mark.parametrize("sharded", [False, True])
def test_engine_parity_coalesced_padded(backend, sharded):
    """Requests of 1-3 queries coalesced and padded to a bucket: each
    equal to the direct search of its own queries."""
    rng = np.random.default_rng(1)
    idx = _index(backend, sharded=sharded)
    qs = _queries(rng, 13)
    with _engine(idx, max_batch=8, k=5) as eng:
        futs, lo = [], 0
        for n in (1, 3, 2, 1, 3, 2, 1):
            futs.append((lo, n, eng.submit(qs[lo:lo + n])))
            lo += n
        for lo, n, fut in futs:
            S, I = fut.result(timeout=WAIT)
            S_ref, I_ref = idx.search_batch(torch.from_numpy(qs[lo:lo + n]),
                                            k=5)
            assert np.array_equal(S, S_ref) and np.array_equal(I, I_ref)
    snap = eng.stats.snapshot()
    assert snap["served"] == snap["submitted"] == 13 and snap["failed"] == 0
    assert set(snap["replica_batches"]) == {0}


def test_flush_reasons_full_deadline_k_switch():
    """full: 8 single requests under a 20 s deadline fill one batch;
    deadline: 3 requests never fill it; k_switch: under a 2 s deadline a
    request with another k closes the batch before it."""
    rng = np.random.default_rng(2)
    idx = _index()
    qs = _queries(rng, 8)
    with _engine(idx, max_batch=8, max_wait_ms=20_000, k=5) as eng:
        futs = [eng.submit(qs[i][None]) for i in range(8)]
        for fut in futs:
            fut.result(timeout=WAIT)
    fl = eng.stats.snapshot()["flush_reasons"]
    assert fl["full"] == 1 and eng.stats.snapshot()["batches"] == 1
    with _engine(idx, max_batch=8, max_wait_ms=50.0, k=5) as eng:
        futs = [eng.submit(qs[i][None]) for i in range(3)]
        for fut in futs:
            fut.result(timeout=WAIT)
    fl = eng.stats.snapshot()["flush_reasons"]
    assert fl["deadline"] >= 1 and fl["full"] == 0
    S4, I4 = idx.search_batch(torch.from_numpy(qs), k=4)
    S9, I9 = idx.search_batch(torch.from_numpy(qs), k=9)
    with _engine(idx, max_batch=8, max_wait_ms=2000.0, k=4) as eng:
        futs = [eng.submit(qs[i][None], k=(4 if i % 2 == 0 else 9))
                for i in range(8)]
        for i, fut in enumerate(futs):
            S, I = fut.result(timeout=WAIT)
            Sr, Ir = (S4, I4) if i % 2 == 0 else (S9, I9)
            assert np.array_equal(S[0], Sr[i]) and np.array_equal(I[0], Ir[i])
    assert eng.stats.snapshot()["flush_reasons"]["k_switch"] >= 1


def test_request_spans_microbatches():
    rng = np.random.default_rng(3)
    idx = _index()
    qs = _queries(rng, 20)
    S_ref, I_ref = idx.search_batch(torch.from_numpy(qs), k=5)
    with _engine(idx, max_batch=8, k=5) as eng:
        S, I = eng.search(qs, timeout=WAIT)
    assert np.array_equal(S, S_ref) and np.array_equal(I, I_ref)
    assert eng.stats.snapshot()["batches"] >= 3


def test_concurrent_submitters_parity():
    rng = np.random.default_rng(4)
    idx = _index(n_docs=50)
    qs = _queries(rng, 48)
    S_ref, I_ref = idx.search_batch(torch.from_numpy(qs), k=6)
    errors = []
    with _engine(idx, max_batch=8, k=6, pipeline_depth=2) as eng:
        def worker(base):
            try:
                for j in range(base, base + 12, 3):
                    S, I = eng.submit(qs[j:j + 3]).result(timeout=WAIT)
                    _held(S, I, S_ref[j:j + 3], I_ref[j:j + 3])
            except BaseException as e:          # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=worker, args=(b,))
                   for b in (0, 12, 24, 36)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
    assert not errors
    snap = eng.stats.snapshot()
    assert snap["served"] == 48 and snap["failed"] == 0


# -------------------------------------------------------- stop and failure
class _Gated:
    """An index whose search waits for ``gate`` (bounded), or raises."""

    def __init__(self, index, raises=None):
        self.index, self.raises = index, raises
        self.gate, self.entered = threading.Event(), threading.Event()
        self.device = index.device

    def search_batch(self, qs, k=10, **kw):
        self.entered.set()
        if self.raises is not None:
            raise self.raises
        self.gate.wait(timeout=WAIT)
        return self.index.search_batch(qs, k=k, **kw)


def test_stop_with_drain_serves_the_backlog():
    """stop(drain=True) serves what was submitted: a batch held by a
    60 s deadline flushes as ``drain`` once the drain wait (5 s) times
    out, and is served before the threads are joined (the same bound)."""
    rng = np.random.default_rng(5)
    idx = _index()
    qs = _queries(rng, 3)
    eng = _engine(idx, max_batch=8, max_wait_ms=60_000, k=5).start()
    futs = [eng.submit(qs[i][None]) for i in range(3)]
    eng.stop(drain=True, timeout=5.0)
    for i, fut in enumerate(futs):
        S, I = fut.result(timeout=WAIT)
        S_ref, I_ref = idx.search_batch(torch.from_numpy(qs[i:i + 1]), k=5)
        assert np.array_equal(S, S_ref) and np.array_equal(I, I_ref)
    snap = eng.stats.snapshot()
    assert snap["flush_reasons"]["drain"] == 1 and snap["failed"] == 0


def test_stop_without_drain_fails_the_backlog():
    """stop(drain=False): the in-flight batch completes, the queued
    requests fail with the engine's stop error and count as failed."""
    rng = np.random.default_rng(6)
    gated = _Gated(_index())
    qs = _queries(rng, 3)
    eng = ServingEngine(VecSearcher(gated), max_batch=1, max_wait_ms=1.0,
                        k=5, warmup_on_start=False, pipeline_depth=1,
                        device="cpu").start()
    first = eng.submit(qs[0][None])
    assert gated.entered.wait(timeout=WAIT)     # batch 1 is in search
    rest = [eng.submit(qs[i][None]) for i in (1, 2)]
    stopper = threading.Thread(target=eng.stop,
                               kwargs=dict(drain=False, timeout=WAIT))
    stopper.start()
    deadline = time.monotonic() + WAIT
    while not eng._stop and time.monotonic() < deadline:
        time.sleep(0.005)
    gated.gate.set()
    stopper.join(timeout=WAIT)
    assert not stopper.is_alive()
    first.result(timeout=WAIT)
    for fut in rest:
        with pytest.raises(RuntimeError, match="stopped"):
            fut.result(timeout=WAIT)
    snap = eng.stats.snapshot()
    assert snap["served"] == 1 and snap["failed"] == 2


def test_index_error_reaches_every_future():
    rng = np.random.default_rng(7)
    gated = _Gated(_index(), raises=ValueError("index fault"))
    qs = _queries(rng, 4)
    with ServingEngine(VecSearcher(gated), max_batch=8, max_wait_ms=20.0,
                       k=5, warmup_on_start=False, device="cpu") as eng:
        futs = [eng.submit(qs[i:i + 2]) for i in (0, 2)]
        for fut in futs:
            with pytest.raises(ValueError, match="index fault"):
                fut.result(timeout=WAIT)
        # the engine keeps serving after a failed batch
        gated.raises = None
        gated.gate.set()
        eng.search(qs[:1], timeout=WAIT)
    snap = eng.stats.snapshot()
    assert snap["failed"] == 4 and snap["served"] == 1


# ---------------------------------------------------------------- hot swap
def test_swap_index_in_flight_parity():
    rng = np.random.default_rng(8)
    idx_a, idx_b = _index(seed=8), _index(seed=8)       # twins
    qs = _queries(rng, 32)
    S_ref, I_ref = idx_a.search_batch(torch.from_numpy(qs), k=5)
    with _engine(idx_a, max_batch=4, k=5) as eng:
        futs = [eng.submit(qs[i][None]) for i in range(16)]
        old = eng.swap_index(idx_b)
        futs += [eng.submit(qs[i][None]) for i in range(16, 32)]
        for i, fut in enumerate(futs):
            S, I = fut.result(timeout=WAIT)
            _held(S, I, S_ref[i:i + 1], I_ref[i:i + 1])
        assert old.wait_drained(timeout=WAIT)
    snap = eng.stats.snapshot()
    assert snap["failed"] == 0 and snap["swaps"] == 1
    gens = snap["generations_seen"]
    assert all(a <= b for a, b in zip(gens, gens[1:]))
    assert eng.generation == 1


def test_watched_directory_swap(tmp_path):
    """Re-publishing the watched artifact bumps its generation; the
    engine loads, pre-warms and swaps it in while 3 threads search; no
    request fails, every result is held to the contract, the engine's
    own loaded copies are released, and no kernel library loads after
    start."""
    rng = np.random.default_rng(9)
    idx = _index("plaid", seed=9)
    qs = _queries(rng, 24)
    S_ref, I_ref = idx.search_batch(torch.from_numpy(qs), k=5)
    d = str(tmp_path / "artifact")
    save_index(idx, d)                                   # generation 1
    eng = _engine(idx, max_batch=8, k=5, index_dir=d, poll_interval_s=0.03)
    eng.start()
    assert eng.generation == 1 and eng._handle.owned
    first = eng._handle
    stop, errors, bad = threading.Event(), [], []

    def load():
        j = 0
        while not stop.is_set():
            i = j % 24
            try:
                S, I = eng.search(qs[i][None], timeout=WAIT)
                _held(S, I, S_ref[i:i + 1], I_ref[i:i + 1])
            except AssertionError:
                bad.append(i)
            except Exception as e:                      # noqa: BLE001
                errors.append(e)
            j += 1

    with CompileCounter() as cc:
        threads = [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + WAIT
        while eng.stats.snapshot()["served"] < 12 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        save_index(idx, d)                              # generation 2
        while eng.generation < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        served = eng.stats.snapshot()["served"]
        while eng.stats.snapshot()["served"] < served + 12 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
    eng.stop()
    assert cc.count == 0
    assert eng.generation == 2, "hot swap not observed"
    assert not errors and not bad
    assert first.wait_drained(timeout=WAIT) and first.index is None
    snap = eng.stats.snapshot()
    assert snap["failed"] == 0 and snap["swaps"] == 1
    assert {1, 2} <= set(snap["generations_seen"])


# --------------------------------------------------------------- replicas
@pytest.fixture(scope="module")
def plaid_artifact(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("replicated") / "plaid")
    idx = _index("plaid", n_docs=60, seed=11)
    save_index(idx, d)
    return idx, d


def test_replicated_lanes_match_direct_and_jax(plaid_artifact):
    """Every lane of ``replicate`` and of ``from_dir`` against the port's
    direct search, and against the JAX package's direct search of the
    same artifact (ids tie-aware, scores within 1e-4)."""
    from repro.core.persist import load_artifact as j_load
    idx, d = plaid_artifact
    qs = _queries(np.random.default_rng(12), 6)
    S_ref, I_ref = idx.search_batch(torch.from_numpy(qs), k=5)
    jS, jI = j_load(d).search_batch(jnp.asarray(qs), k=5)
    _held(S_ref, I_ref, np.asarray(jS), np.asarray(jI))
    shared = ReplicatedIndex.replicate(idx, 3)
    copies = ReplicatedIndex.from_dir(d, n_replicas=2, device="cpu")
    assert len({id(ix) for ix in copies._inners}) == 2
    for rep in (shared, copies):
        assert rep.n_docs == idx.n_docs and rep.n_vectors() == idx.n_vectors()
        for r in range(rep.n_replicas):
            S, I = rep.search_batch_on(r, torch.from_numpy(qs), k=5)
            assert np.array_equal(S, S_ref) and np.array_equal(I, I_ref)
        S, I = rep.search_batch(torch.from_numpy(qs), k=5)
        assert np.array_equal(I, I_ref)
    with pytest.raises(RuntimeError, match="desync"):
        copies.add(_unit_docs(np.random.default_rng(0), n=1))
    copies.delete([int(I_ref[0, 0])])
    for r in range(copies.n_replicas):
        assert int(I_ref[0, 0]) not in copies.search_batch_on(
            r, torch.from_numpy(qs), k=5)[1]
    copies.set_probe_kernel("host")
    assert all(ix.probe_kernel == "host" for ix in copies._inners)
    copies.close()
    assert copies.closed


def test_replicated_sharded_probe_split_and_table(tmp_path):
    idx = _index("plaid", n_docs=60, seed=13, sharded=True)
    d = str(tmp_path / "sharded")
    idx.save(d)
    qs = torch.from_numpy(_queries(np.random.default_rng(13), 4))
    S_ref, I_ref = idx.search_batch(qs, k=5)
    rep = ReplicatedIndex.from_dir(d, n_replicas=2, device="cpu")
    for r in range(2):
        S, I = rep.search_batch_on(r, qs, k=5)
        assert np.array_equal(S, S_ref) and np.array_equal(I, I_ref)
    assert all(ix.probe_threads == max(1, idx.probe_threads // 2)
               for ix in rep._inners)
    rep.close()
    assert all(ix.closed for ix in rep._inners)
    table = serve_device_table(3, 2, "cpu")
    assert table == [[torch.device("cpu")] * 2] * 3


def test_engine_replica_router(plaid_artifact):
    idx, _ = plaid_artifact
    qs = _queries(np.random.default_rng(14), 16)
    S_ref, I_ref = idx.search_batch(torch.from_numpy(qs), k=5)
    with _engine(idx, max_batch=4, k=5, n_replicas=2) as eng:
        assert isinstance(eng._handle.index, ReplicatedIndex)
        futs = [eng.submit(qs[i:i + 2]) for i in range(0, 16, 2)]
        for j, fut in enumerate(futs):
            S, I = fut.result(timeout=WAIT)
            _held(S, I, S_ref[2 * j:2 * j + 2], I_ref[2 * j:2 * j + 2])
    snap = eng.stats.snapshot()
    assert snap["failed"] == 0 and sum(snap["replica_batches"].values()) \
        == snap["batches"]


def test_open_loop_fixed_seed():
    rng = np.random.default_rng(15)
    idx = _index()
    qs = _queries(rng, 16)
    S_ref, I_ref = idx.search_batch(torch.from_numpy(qs), k=5)
    halfway = []
    with _engine(idx, max_batch=8, k=5) as eng:
        row = run_open_loop(eng, qs, arrival_qps=400.0, n_queries=40, k=5,
                            seed=3, collect_results=True,
                            on_halfway=lambda: halfway.append(1))
    assert row["errors"] == 0 and row["n_queries"] == 40 and halfway == [1]
    for i, (S, I) in enumerate(row["results"]):
        _held(S, I, S_ref[i % 16:i % 16 + 1], I_ref[i % 16:i % 16 + 1])
    assert eng.stats.snapshot()["served"] == 40


# ---------------------------------------------------- through the encoder
@pytest.fixture(scope="module")
def smoke_retriever(tmp_path_factory):
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    cfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    model = rt.init_colbert(cfg, seed=0, device="cpu")
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "engine", n_docs=64, n_queries=24, n_topics=6, doc_len_mean=30,
        doc_len_std=6, seed=2), vocab_size=cfg.trunk.vocab_size)
    d = str(tmp_path_factory.mktemp("engine") / "plaid")
    r = rt.Retriever.build(model, corpus.doc_token_batch(cfg.doc_maxlen - 2),
                           rt.RetrieverSpec(
                               pooling=rt.PoolingSpec("ward", 2),
                               index=rt.IndexSpec.from_config(
                                   cfg, ndocs=4096)),
                           out_dir=d, encode_batch=16, device="cpu")
    return r, d, corpus.query_token_batch(cfg.query_maxlen - 2)


def test_retriever_serve_parity_through_the_encoder(smoke_retriever):
    """``Retriever.serve`` with 4 submitter threads sending requests of
    1-8 queries: every request against ``searcher.search`` of the same
    tokens, held to the contract and bitwise (the searcher encodes every
    chunk at its ``encode_batch`` width)."""
    r, d, q = smoke_retriever
    from repro_torch.core.persist import artifact_generation
    spec = rt.ServeSpec(max_batch=16, max_wait_ms=2.0, k=5)
    errors, held = [], []
    with r.serve(spec, index_dir=d,
                 index_generation=artifact_generation(d)) as eng:
        with CompileCounter() as cc:
            def worker(seed):
                rng = np.random.default_rng(seed)
                try:
                    for _ in range(6):
                        lo, n = int(rng.integers(0, 16)), \
                            int(rng.integers(1, 9))
                        S, I = eng.submit(q[lo:lo + n]).result(timeout=WAIT)
                        held.append((lo, n, S, I))
                except BaseException as e:              # noqa: BLE001
                    errors.append(e)
            threads = [threading.Thread(target=worker, args=(s,))
                       for s in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
                assert not t.is_alive()
    assert not errors and len(held) == 24 and cc.count == 0
    for lo, n, S, I in held:
        S_ref, I_ref = r.searcher.search(q[lo:lo + n], k=5)
        _held(S, I, S_ref, I_ref)
        # one encode width: a coalesced row is encoded as it is alone
        assert np.array_equal(S, S_ref) and np.array_equal(I, I_ref)
    snap = eng.stats.snapshot()
    assert snap["failed"] == 0 and snap["served"] == snap["submitted"]


def test_serve_cli_closed_and_open_loop(tmp_path, capsys):
    from repro_torch.launch import serve
    d = str(tmp_path / "cli")
    assert serve.main(["--device", "cpu", "--dataset", "nfcorpus",
                       "--queries", "8", "--batch-sizes", "1,4",
                       "--index-dir", d]) == 0
    out = capsys.readouterr().out
    assert "index: " in out and "saved to" in out and "QPS" in out
    assert serve.main(["--device", "cpu", "--dataset", "nfcorpus",
                       "--queries", "12", "--arrival-qps", "200",
                       "--index-dir", d]) == 0
    out = capsys.readouterr().out
    assert "loaded" in out and "achieved" in out
    row = [ln for ln in out.splitlines() if ln.strip().startswith("200.0")]
    assert row and row[0].split()[-1] == "0"            # no errors


@pytest.mark.parametrize("backend,ndocs", [("flat", 4096), ("hnsw", 4096),
                                           ("plaid", 4096), ("plaid", 16)])
def test_candidate_widths_equal_reference(backend, ndocs):
    """``MultiVectorIndex.candidate_widths`` against the reference's on
    the same docs (plaid with the reference's codec): the slate widths
    a batch shape can reach and whether the dense dispatch is."""
    from repro.core.index import MultiVectorIndex as JIndex
    from repro_torch.core.quantization import ResidualCodec
    docs = _unit_docs(np.random.default_rng(16), n=70)
    kw = dict(doc_maxlen=24, n_centroids=8, nprobe=2, ndocs=ndocs,
              hnsw_candidates=64)
    jidx = JIndex(dim=DIM, backend=backend, **kw)
    jidx.add([d.numpy() for d in docs])
    idx = MultiVectorIndex(dim=DIM, backend=backend, device="cpu", **kw)
    if backend == "plaid":
        c = jidx._plaid.codec
        idx.set_codec(ResidualCodec(*(torch.tensor(np.asarray(a)) for a in
                                      (c.centroids, c.cutoffs, c.values)),
                                    c.bits))
    idx.add(docs)
    for nq, lq in ((1, LQ), (3, 32)):
        qs = np.zeros((nq, lq, DIM), np.float32)
        assert idx.candidate_widths(torch.from_numpy(qs)) == \
            jidx.candidate_widths(jnp.asarray(qs))
    assert MultiVectorIndex(dim=DIM, device="cpu").candidate_widths(
        torch.zeros((1, LQ, DIM))) == ([], False)
