"""The port's ``ShardedIndex`` (``repro_torch/core/sharded.py``) against
the JAX package, after ``tests/test_sharded.py``: per backend (flat,
hnsw, plaid with the reference's codec) on the same seeded numpy docs.

* At exhaustive candidate settings the sharded search equals the
  monolithic index, the port's and the JAX package's; so after a
  delete; ties go to the lower global id across a shard boundary.
* Empty shards are skipped; single-doc and empty indexes; empty inputs
  are typed no-ops; ``add`` spills with global ids, in the JAX package's
  shard layout; an incremental add equals a bulk add.
* Artifacts both ways: the port loads a JAX ``save_sharded`` artifact,
  the JAX package loads the port's, with equal searches;
  ``load_artifact`` dispatches all four kinds (``residual_codec`` both
  ways); the empty sharded index round-trips.
* ``topk_shard`` against the reference's; the launch counters under 8
  threads.

Tolerances: shard layouts, doc ids and slates exact; rankings tie-aware
and scores ``allclose`` at rtol 1e-5 / atol 1e-5 (f32 sums in another
order; within the port, the dense and packed reranks of one codec).
The property case is a fixed-seed parametrised grid, so no saved
example is replayed.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import persist as jpersist
from repro.core.index import MultiVectorIndex as JIndex
from repro.core.sharded import ShardedIndex as JSharded
from repro_torch.core import persist
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.maxsim import tie_aware_mismatches, topk_shard
from repro_torch.core.persist import IndexFormatError, load_artifact
from repro_torch.core.quantization import ResidualCodec
from repro_torch.core.sharded import ShardedIndex

BACKENDS = ["flat", "hnsw", "plaid"]
KW = dict(doc_maxlen=24, n_centroids=16, ndocs=4096, hnsw_candidates=8192)
DIM = 16
RTOL = ATOL = 1e-5


def unit_docs(rng, n=40, lo=4, hi=20):
    docs = []
    for _ in range(n):
        v = rng.normal(size=(rng.integers(lo, hi), DIM)).astype(np.float32)
        docs.append(v / np.linalg.norm(v, axis=-1, keepdims=True))
    return docs


def unit_queries(rng, n=6, lq=5):
    q = rng.normal(size=(n, lq, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def port_codec(jcodec) -> ResidualCodec:
    return ResidualCodec(*(torch.tensor(np.asarray(a)) for a in
                           (jcodec.centroids, jcodec.cutoffs, jcodec.values)),
                         jcodec.bits)


def port_sharded(backend, cap, codec=None, **kw):
    """A CPU ShardedIndex; a plaid one starts from ``codec``."""
    sh = ShardedIndex(dim=DIM, backend=backend, shard_max_vectors=cap,
                      device="cpu", **dict(KW, **kw))
    if codec is not None:
        sh._new_shard().set_codec(codec)
    return sh


def build_all(backend, docs, cap=160):
    """(port sharded, port mono, JAX sharded, JAX mono) over one corpus,
    one codec (the JAX sharded index's) for plaid."""
    js = JSharded(dim=DIM, backend=backend, shard_max_vectors=cap, **KW)
    js.add(docs)
    jm = JIndex(dim=DIM, backend=backend, **KW)
    tm = MultiVectorIndex(dim=DIM, backend=backend, device="cpu", **KW)
    codec = None
    if backend == "plaid":
        jm.set_codec(js.codec())
        codec = port_codec(js.codec())
        tm.set_codec(codec)
    ts = port_sharded(backend, cap, codec)
    ts.add(docs)
    jm.add(docs)
    tm.add(docs)
    return ts, tm, js, jm


def search_np(index, qs, k):
    S, I = index.search_batch(qs, k=k)
    return np.asarray(S), np.asarray(I)


def assert_same(S0, I0, S1, I1):
    assert tie_aware_mismatches(I0, S0, I1, S1, ATOL) == 0
    np.testing.assert_allclose(S1, S0, rtol=RTOL, atol=ATOL)


def assert_layout(ts, js):
    assert ts.doc_base == [int(b) for b in js.doc_base]
    assert [s.n_docs for s in ts.shards] == [s.n_docs for s in js.shards]
    assert [s.n_vectors() for s in ts.shards] == \
        [s.n_vectors() for s in js.shards]


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_matches_monolithic(backend):
    rng = np.random.default_rng(0)
    docs, qs = unit_docs(rng), unit_queries(rng)
    ts, tm, js, jm = build_all(backend, docs)
    assert ts.n_shards >= 2
    assert_layout(ts, js)
    assert (ts.n_docs, ts.n_vectors()) == (tm.n_docs, tm.n_vectors())
    S1, I1 = ts.search_batch(qs, k=8)
    for ref in (tm, jm):
        assert_same(*search_np(ref, qs, 8), S1, I1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_delete_parity(backend):
    rng = np.random.default_rng(1)
    docs, qs = unit_docs(rng), unit_queries(rng)
    ts, tm, js, jm = build_all(backend, docs)
    victims = [0, 13, 25, 39]               # spread across shards
    for ix in (ts, tm, jm):
        ix.delete(victims)
    S1, I1 = ts.search_batch(qs, k=10)
    for ref in (tm, jm):
        assert_same(*search_np(ref, qs, 10), S1, I1)
    assert not np.isin(I1[I1 >= 0], victims).any()


def test_tie_break_order_matches_monolithic():
    """Duplicate docs across a shard boundary score the same; the merge
    orders them lowest global id first, as the monolithic indexes do."""
    rng = np.random.default_rng(2)
    base = unit_docs(rng, n=6, lo=5, hi=9)
    docs = base + base                      # ids 0..5 == ids 6..11
    qs = unit_queries(rng, n=4)
    ts = port_sharded("flat", sum(len(d) for d in base))
    ts.add(docs)
    assert ts.n_shards == 2
    S1, I1 = ts.search_batch(qs, k=12)
    jm = JIndex(dim=DIM, backend="flat", **KW)
    jm.add(docs)
    np.testing.assert_array_equal(search_np(jm, qs, 12)[1], I1)
    for row in I1:
        pos = {int(d): i for i, d in enumerate(row)}
        for d in range(6):
            assert pos[d] == pos[d + 6] - 1, row


def test_topk_shard_matches_reference():
    from repro.core.maxsim import topk_shard as jtopk_shard
    rng = np.random.default_rng(9)
    scores = np.round(rng.normal(size=(4, 37)), 1).astype(np.float32)
    scores[:, 30:] = -np.inf                # invalid slots, and many ties
    cand = rng.permutation(40)[:37][None].repeat(4, 0).astype(np.int64)
    for c in (None, cand):
        js, ji = jtopk_shard(jnp.asarray(scores), c, 9, base=100)
        ts, ti = topk_shard(torch.from_numpy(scores),
                            None if c is None else torch.from_numpy(c), 9,
                            base=100)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        fin = np.isfinite(np.asarray(js))
        np.testing.assert_array_equal(ti.numpy()[fin], np.asarray(ji)[fin])
        assert ti.dtype == torch.int64


def test_empty_shard_is_skipped():
    rng = np.random.default_rng(3)
    docs, qs = unit_docs(rng, n=12), unit_queries(rng)
    parts = [MultiVectorIndex(dim=DIM, backend="flat", device="cpu", **KW)
             for _ in range(3)]
    parts[0].add(docs[:7])
    parts[2].add(docs[7:])
    sharded = ShardedIndex.from_parts(parts, [0, 7, 7])
    S1, I1, probe_s = sharded.search_batch_with_stats(qs, k=5)
    assert probe_s[1] == 0.0 and len(probe_s) == 3
    jm = JIndex(dim=DIM, backend="flat", **KW)
    jm.add(docs)
    assert_same(*search_np(jm, qs, 5), S1, I1)
    with pytest.raises(ValueError):
        ShardedIndex.from_parts(parts, [0, 6, 7])


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_doc_and_empty_index(backend):
    rng = np.random.default_rng(4)
    qs = unit_queries(rng, n=3)
    empty = port_sharded(backend, 0)
    S, I = empty.search_batch(qs, k=4)
    assert (I == -1).all() and np.isneginf(S).all()
    one = port_sharded(backend, 8)
    ids = one.add(unit_docs(rng, n=1, lo=5, hi=9))
    np.testing.assert_array_equal(ids, [0])
    S, I = one.search_batch(qs, k=4)
    assert (I[:, 0] == 0).all() and (I[:, 1:] == -1).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_input_edges_are_typed_noops(backend):
    rng = np.random.default_rng(13)
    qs = unit_queries(rng, n=2)
    ix = port_sharded(backend, 0)
    owner = ix.shard_of(np.array([]))
    assert owner.shape == (0,) and owner.dtype == np.int64
    assert len(ix.add([])) == 0
    ix.delete([])
    ix.delete(np.array([], np.int64))
    ix = port_sharded(backend, 80)
    ix.add(unit_docs(rng, n=10))
    S0, I0 = ix.search_batch(qs, k=4)
    ids = ix.add([])
    assert ids.shape == (0,) and ids.dtype == np.int64
    ix.delete([])
    owner = ix.shard_of(np.array([], np.float64))
    assert owner.shape == (0,) and owner.dtype == np.int64
    assert ix.n_docs == 10
    S, I = ix.search_batch(qs, k=4)
    np.testing.assert_array_equal(I0, I)
    np.testing.assert_array_equal(S0, S)


# ------------------------------------------------------------ id routing
def test_add_spills_and_ids_are_global():
    rng = np.random.default_rng(5)
    docs = unit_docs(rng, n=30, lo=6, hi=12)
    ts = port_sharded("flat", 50)
    ids = ts.add(docs)
    np.testing.assert_array_equal(ids, np.arange(30))
    js = JSharded(dim=DIM, backend="flat", shard_max_vectors=50, **KW)
    np.testing.assert_array_equal(js.add(docs), ids)
    assert_layout(ts, js)
    assert ts.n_shards >= 3
    for s in ts.shards:
        assert s.n_vectors() <= 50 + 12
    owner = ts.shard_of(np.arange(30))
    np.testing.assert_array_equal(owner, js.shard_of(np.arange(30)))
    for s in range(ts.n_shards):
        assert (owner == s).sum() == ts.shards[s].n_docs
    with pytest.raises(IndexError):
        ts.shard_of([30])


def test_incremental_add_continues_ids_and_matches_bulk():
    rng = np.random.default_rng(6)
    docs = unit_docs(rng, n=20, lo=6, hi=12)
    qs = unit_queries(rng)
    bulk = port_sharded("flat", 60)
    bulk.add(docs)
    inc = port_sharded("flat", 60)
    got = [inc.add(docs[i:i + 3]) for i in range(0, 20, 3)]
    np.testing.assert_array_equal(np.concatenate(got), np.arange(20))
    S0, I0 = bulk.search_batch(qs, k=6)
    S1, I1 = inc.search_batch(qs, k=6)
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(S0, S1)


@pytest.mark.parametrize("seed,backend,method,factor", [
    (0, "flat", "ward", 2), (1, "hnsw", "sequential", 4),
    (2, "plaid", "kmeans", 2), (3, "plaid", "ward", 1),
    (4, "flat", "kmeans", 4), (5, "hnsw", "ward", 2),
    (6, "plaid", "sequential", 2), (7, "plaid", "ward", 4)])
def test_sharded_equals_monolithic_pooled(seed, backend, method, factor):
    """Docs made by the port's pooling stage (every method's geometry:
    short docs, renormalized means), 2-4 shards: the port's sharded
    search equals the port's and the JAX package's monolithic index."""
    from repro_torch.core.pooling import compact_pooled, pool_doc_embeddings
    rng = np.random.default_rng(seed)
    n_docs, N = int(rng.integers(6, 24)), 20
    x = rng.normal(size=(n_docs, N, DIM)).astype(np.float32)
    lens = rng.integers(4, N + 1, size=n_docs)
    mask = np.arange(N)[None, :] < lens[:, None]
    pooled, pmask = pool_doc_embeddings(torch.from_numpy(x),
                                        torch.from_numpy(mask), factor,
                                        method)
    flat, counts = compact_pooled(pooled, pmask)
    docs = [d.numpy() for d in torch.split(flat, counts.tolist())]
    qs = unit_queries(rng, n=4)
    n_shards = 2 + seed % 3
    cap = max(sum(len(d) for d in docs) // n_shards,
              max(len(d) for d in docs))
    ts, tm, js, jm = build_all(backend, docs, cap)
    assert_layout(ts, js)
    k = min(8, n_docs)
    S1, I1 = ts.search_batch(qs, k=k)
    for ref in (tm, jm):
        assert_same(*search_np(ref, qs, k), S1, I1)


# ------------------------------------------------------------ persistence
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sharded_artifact_both_ways(backend, direction, tmp_path):
    rng = np.random.default_rng(7)
    docs, qs = unit_docs(rng), unit_queries(rng)
    ts, _, js, _ = build_all(backend, docs)
    for ix in (ts, js):
        ix.delete([2, 21])
    root = str(tmp_path / "root")
    if direction == "port_to_jax":
        manifest = ts.save(root)
        loaded = jpersist.load_artifact(root)
        assert isinstance(loaded, JSharded)
        S0, I0 = ts.search_batch(qs, k=8)
        S1, I1 = search_np(loaded, qs, 8)
    else:
        manifest = js.save(root)
        loaded = load_artifact(root, device="cpu")
        assert isinstance(loaded, ShardedIndex)
        S0, I0 = search_np(js, qs, 8)
        S1, I1 = loaded.search_batch(qs, k=8)
    assert manifest["kind"] == "sharded_index"
    assert persist.read_manifest(root) == jpersist.read_manifest(root)
    assert loaded.n_shards == ts.n_shards and loaded.n_docs == ts.n_docs
    assert [int(b) for b in loaded.doc_base] == ts.doc_base
    assert_same(S0, I0, S1, I1)
    total = persist.artifact_bytes(root)
    assert total == jpersist.artifact_bytes(root) > 0
    per_shard = sum(persist.artifact_bytes(str(tmp_path / "root" / e["dir"]))
                    for e in manifest["shards"])
    assert total == per_shard


def test_load_artifact_dispatches_every_kind(tmp_path):
    """All four artifact kinds, written by the port, load in the port
    and in the JAX package; a codec written by either package loads in
    the other with equal tables."""
    from repro.retrieval.cascade import CascadeIndex as JCascade
    from repro_torch.retrieval.cascade import CascadeIndex
    rng = np.random.default_rng(8)
    docs = unit_docs(rng, n=10)
    mono = MultiVectorIndex(dim=DIM, backend="flat", device="cpu", **KW)
    mono.add(docs)
    mono.save(str(tmp_path / "mono"))
    sharded = port_sharded("flat", 40)
    sharded.add(docs)
    sharded.save(str(tmp_path / "sharded"))
    cascade = CascadeIndex(dim=DIM, doc_maxlen=24, device="cpu")
    cascade.add([torch.from_numpy(d) for d in docs[:4]],
                [torch.from_numpy(d) for d in docs[:4]])
    cascade.save(str(tmp_path / "cascade"))
    jplaid = JIndex(dim=DIM, backend="plaid", **KW)
    jplaid.add(docs)
    jpersist.save_codec(jplaid._plaid.codec, str(tmp_path / "jcodec"))
    codec = port_codec(jplaid._plaid.codec)
    persist.save_codec(codec, str(tmp_path / "codec"))
    kinds = {"mono": (MultiVectorIndex, JIndex),
             "sharded": (ShardedIndex, JSharded),
             "cascade": (CascadeIndex, JCascade)}
    for name, (tcls, jcls) in kinds.items():
        path = str(tmp_path / name)
        assert isinstance(load_artifact(path, device="cpu"), tcls)
        assert isinstance(jpersist.load_artifact(path), jcls)
    for name in ("codec", "jcodec"):
        path = str(tmp_path / name)
        tc = load_artifact(path, device="cpu")
        jc = jpersist.load_artifact(path)
        assert isinstance(tc, ResidualCodec) and tc.bits == jc.bits == 2
        for a in ("centroids", "cutoffs", "values"):
            np.testing.assert_array_equal(getattr(tc, a).numpy(),
                                          np.asarray(getattr(jc, a)))
            np.testing.assert_array_equal(getattr(tc, a).numpy(),
                                          getattr(codec, a).numpy())
    with pytest.raises(IndexFormatError):
        CascadeIndex.from_dir(str(tmp_path / "sharded"), device="cpu")
    with pytest.raises(IndexFormatError):
        ShardedIndex.load(str(tmp_path / "mono"), device="cpu")
    with pytest.raises(IndexFormatError):
        persist.load_codec(str(tmp_path / "mono"), device="cpu")
    jpersist.write_artifact(str(tmp_path / "odd"), {"kind": "odd"}, {})
    with pytest.raises(IndexFormatError, match="unknown artifact kind"):
        load_artifact(str(tmp_path / "odd"), device="cpu")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_empty_sharded_roundtrip(writer, tmp_path):
    path = str(tmp_path / "empty")
    if writer == "port":
        port_sharded("plaid", 64).save(path)
        assert jpersist.load_artifact(path).shard_max_vectors == 64
    else:
        JSharded(dim=DIM, backend="plaid", shard_max_vectors=64,
                 **KW).save(path)
    loaded = load_artifact(path, device="cpu")
    assert isinstance(loaded, ShardedIndex)
    assert loaded.n_docs == 0 and loaded.backend == "plaid"
    assert loaded.shard_max_vectors == 64
    assert loaded.index_kw == KW


# ------------------------------------------------------------- fan-out
def test_probe_pool_fanout_equals_serial_and_close():
    rng = np.random.default_rng(10)
    docs, qs = unit_docs(rng), unit_queries(rng)
    ts = port_sharded("flat", 120, probe_threads=1)
    ts.add(docs)
    S0, I0 = ts.search_batch(qs, k=8)
    ts.set_probe_threads(4)
    assert ts.probe_threads == 4 and ts.probe_threads_cfg == 4
    S1, I1 = ts.search_batch(qs, k=8)
    assert len(ts.last_probe_s) == ts.n_shards
    ts.place(["cpu"] * ts.n_shards)
    S2, I2 = ts.search_batch(qs, k=8)
    ts.close()
    assert ts.closed
    S3, I3 = ts.search_batch(qs, k=8)
    for S, I in ((S1, I1), (S2, I2), (S3, I3)):
        np.testing.assert_array_equal(I0, I)
        np.testing.assert_array_equal(S0, S)
    with pytest.raises(ValueError):
        ts.place(["cpu"])
    with pytest.raises(ValueError):
        ts.set_probe_kernel("nope")


def test_launch_counter_is_exact_under_threads():
    """At least 8 threads, more than the cores, bump one counter with a
    short switch interval: a lost update would leave the total short."""
    import os
    import sys
    from repro_torch.kernels import LaunchCounter
    c = LaunchCounter()
    n, per = max(8, (os.cpu_count() or 1) + 1), 20000

    def bump():
        for _ in range(per):
            c.bump()
        c.bump(2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert c.count == n * (per + 2)
    c.reset()
    assert c.count == 0
