"""Index mutation in the port (``add`` after the build, ``delete``) against
the JAX reference, for each backend.

One sequence runs in both packages on the same seeded numpy docs: build,
add, delete, search, save, load, search; the artifacts are also read
across packages. Plaid shares the reference's codec (``set_codec``), so
both encode with the same centroids and cutoffs: candidate slates equal
exactly on the host and the device plan, ids equal tie-aware and scores
to rtol 1e-5 / atol 1e-4 (f32 dot products and sums in another order).
"""
import numpy as np
import pytest
import torch

from repro.core import persist as jpersist
from repro.core import plaid as jplaid
from repro.core.index import MultiVectorIndex as JIndex
from repro_torch.core import persist
from repro_torch.core.docstore import DocStore
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.core.quantization import ResidualCodec, decode

DIM = 16
RTOL, ATOL = 1e-5, 1e-4
KW = {"flat": dict(doc_maxlen=24),
      "hnsw": dict(doc_maxlen=24, hnsw_m=6, hnsw_ef_construction=32,
                   hnsw_candidates=48),
      "plaid": dict(doc_maxlen=24, n_centroids=32, nprobe=2, ndocs=16)}
DEAD = [3, 17, 45, 61]


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _docs(rng, n, lo=2, hi=6):
    return [_unit(rng, (int(rng.integers(lo, hi)), DIM)) for _ in range(n)]


def _torch_codec(c):
    return ResidualCodec(*(torch.tensor(np.asarray(a)) for a in
                           (c.centroids, c.cutoffs, c.values)), c.bits)


def _mutated(backend, seed=0, n=120, n_add=24, dead=DEAD, **kw):
    """Build, add, delete in both packages -> (jidx, tidx, rng)."""
    rng = np.random.default_rng(seed)
    kw = dict(KW[backend], **kw)
    jidx = JIndex(dim=DIM, backend=backend, **kw)
    tidx = MultiVectorIndex(dim=DIM, backend=backend, device="cpu", **kw)
    first, more = _docs(rng, n), _docs(rng, n_add)
    jidx.add(first)
    if backend == "plaid":
        tidx.set_codec(_torch_codec(jidx._plaid.codec))
    tidx.add([torch.from_numpy(d) for d in first])
    ids = tidx.add([torch.from_numpy(d) for d in more])
    np.testing.assert_array_equal(ids, jidx.add(more))
    np.testing.assert_array_equal(ids, np.arange(n, n + n_add))
    jidx.delete(list(dead))
    tidx.delete(list(dead))
    return jidx, tidx, rng


def _same_results(jidx, tidx, qs, k=7):
    jS, jI = jidx.search_batch(qs, k=k)
    tS, tI = tidx.search_batch(torch.from_numpy(qs), k=k)
    jS, jI = np.asarray(jS), np.asarray(jI)
    assert tie_aware_mismatches(jI, jS, tI, tS, ATOL) == 0
    np.testing.assert_allclose(tS, jS, rtol=RTOL, atol=ATOL)
    return tS, tI


@pytest.mark.parametrize("backend", ["flat", "hnsw", "plaid"])
def test_crud_sequence_equals_reference(tmp_path, backend):
    """build, add, delete, search, save, load, search."""
    jidx, tidx, rng = _mutated(backend)
    qs = _unit(rng, (6, 4, DIM))
    tS, tI = _same_results(jidx, tidx, qs)
    assert not np.isin(tI, DEAD).any()
    assert tidx.deleted == jidx.deleted == set(DEAD)
    assert tidx.n_vectors() == jidx.n_vectors()
    assert tidx.nbytes() == jidx.nbytes()
    tidx.save(str(tmp_path / "t"))
    jidx.save(str(tmp_path / "j"))
    tl = MultiVectorIndex.load(str(tmp_path / "t"), device="cpu")
    jl = jpersist.load_index(str(tmp_path / "j"))
    lS, lI = _same_results(jl, tl, qs)
    assert tie_aware_mismatches(tI, tS, lI, lS, ATOL) == 0
    np.testing.assert_allclose(lS, tS, rtol=RTOL, atol=ATOL)
    assert tl.deleted == set(DEAD)


@pytest.mark.parametrize("backend", ["flat", "hnsw", "plaid"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mutated_artifacts_both_ways(tmp_path, backend, direction):
    """A mutated index saved by one package searches the same loaded in
    the other; both writers give the same payloads (dead docs compacted
    to zero-length spans)."""
    jidx, tidx, rng = _mutated(backend, seed=1)
    qs = _unit(rng, (5, 4, DIM))
    path = str(tmp_path / direction)
    if direction == "jax_to_port":
        jidx.save(path)
        _same_results(jidx, persist.load_index(path, device="cpu"), qs)
    else:
        tidx.save(path)
        _same_results(jpersist.load_index(path), tidx, qs)
    ours = persist.index_payloads(tidx)[1]
    theirs = jpersist.index_payloads(jidx)[1]
    assert sorted(ours) == sorted(theirs)
    lens = np.diff(ours["doc_offsets" if backend == "plaid" else "offsets"])
    assert (lens[DEAD] == 0).all()
    for name in theirs:
        np.testing.assert_array_equal(ours[name], theirs[name])


@pytest.mark.parametrize("probe", ["host", "device"])
@pytest.mark.parametrize("kw", [dict(), dict(ndocs=64, n_centroids=64,
                                             nprobe=1)])
def test_plaid_slates_after_mutation_equal_reference(probe, kw):
    """The port's host and device plans after add and delete give the
    reference host path's slates: equal ids, validity and order (host),
    equal sets (device, which orders an unpruned slate by id too)."""
    jidx, tidx, rng = _mutated("plaid", seed=2, **kw)
    qs = _unit(rng, (6, 3, DIM))
    tidx.probe_kernel = probe
    use_dev, _ = tidx._probe_plan(3)
    assert use_dev == (probe == "device")
    jc, jm = jplaid.plaid_candidates(jidx._plaid, qs, nprobe=jidx.nprobe,
                                     t_cs=jidx.t_cs, ndocs=jidx.ndocs,
                                     live=jidx._live(), probe_kernel="host")
    tc, tm = tidx.candidates(torch.from_numpy(qs))
    tc, tm = tc.numpy(), tm.numpy()
    if probe == "host":
        assert tc.shape == jc.shape
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(np.where(tm, tc, -1),
                                      np.where(jm, jc, -1))
    for i in range(len(qs)):
        assert set(tc[i][tm[i]].tolist()) == set(jc[i][jm[i]].tolist())
    assert not np.isin(tc[tm], DEAD).any()
    assert (tc[tm] >= 120).any()                  # added docs are served
    _same_results(jidx, tidx, qs)


def test_add_after_build_keeps_the_codec_and_refreshes_the_views():
    """The first add's codec encodes every later add; the cached device
    views (packed view, device IVF, live mask) are rebuilt after a
    mutation."""
    jidx, tidx, rng = _mutated("plaid", seed=3, n_add=0, dead=())
    p = tidx._plaid
    codec = p.codec
    tidx.search_batch(torch.from_numpy(_unit(rng, (2, 3, DIM))), k=3)
    _ = p.padded_packed(), p.device_ivf(), tidx._live_dev()
    more = _docs(rng, 10, lo=20, hi=24)            # longer than any doc
    tidx.add([torch.from_numpy(d) for d in more])
    jidx.add(more)
    assert tidx._plaid.codec is codec
    assert p._packed_padded is None and p._device_ivf is None
    assert tidx._live_dev_cache is None
    assert p.padded_packed()[0].shape == (130, max(len(d) for d in more))
    assert p.device_ivf().n_docs == 130
    np.testing.assert_array_equal(p.device_ivf().doc_member.numpy(),
                                  np.asarray(jidx._plaid.device_ivf()
                                             .doc_member))
    tidx._live_dev()
    tidx.delete([1])
    jidx.delete([1])
    assert tidx._live_dev_cache is None
    assert not bool(tidx._live_dev()[1])
    _same_results(jidx, tidx, _unit(rng, (4, 3, DIM)))


def test_plaid_index_delete_compacts_as_the_reference():
    jidx, tidx, _ = _mutated("plaid", seed=4, dead=())
    tidx._plaid.recon_store()
    jidx._plaid.delete([0, 7, 130])
    tidx._plaid.delete([0, 7, 130])
    jp, tp = jidx._plaid, tidx._plaid
    assert tp.n_docs == jp.n_docs == 141
    assert tp.recon is None
    np.testing.assert_array_equal(tp.assignments.numpy(),
                                  np.asarray(jp.assignments))
    np.testing.assert_array_equal(tp.codes.numpy().view(np.uint32),
                                  np.asarray(jp.codes))
    for a in ("vec2doc", "doc_offsets"):
        np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
    np.testing.assert_array_equal(tp.ivf.ids, jp.ivf.ids)
    np.testing.assert_array_equal(tp.ivf.offsets, jp.ivf.offsets)
    assert tp.nbytes() == jp.nbytes()


def test_recon_store_stays_coherent_across_add():
    """A built reconstruction store gains the added docs' decoded rows:
    equal to a store decoded afresh and to the reference's."""
    jidx, tidx, rng = _mutated("plaid", seed=5, n_add=0, dead=())
    store = tidx._plaid.recon_store()
    jidx._plaid.recon_store()
    more = _docs(rng, 8)
    tidx.add([torch.from_numpy(d) for d in more])
    jidx.add(more)
    p = tidx._plaid
    assert p.recon is store and store.n_docs == 128
    np.testing.assert_array_equal(store.offsets, p.doc_offsets)
    np.testing.assert_array_equal(store.flat.numpy(),
                                  decode(p.codec, p.assignments,
                                         p.codes).numpy())
    np.testing.assert_allclose(store.flat.numpy(),
                               np.concatenate(jidx._plaid.recon
                                              .docs_list()), atol=1e-6)
    assert p.nbytes() == jidx._plaid.nbytes()
    tidx.packed_rerank = jidx.packed_rerank = False
    _same_results(jidx, tidx, _unit(rng, (4, 3, DIM)))


@pytest.mark.parametrize("backend", ["flat", "hnsw", "plaid"])
def test_index_crud(backend):
    """The reference's CRUD scenario (``tests/test_retrieval.py``) on the
    port: add returns the next ids, a deleted top hit is gone."""
    rng = np.random.default_rng(1)
    topics = rng.normal(size=(4, DIM)).astype(np.float32)
    docs = []
    for i in range(40):
        v = topics[i % 4] + 0.3 * rng.normal(size=(rng.integers(6, 20), DIM))
        docs.append((v / np.linalg.norm(v, axis=-1,
                                        keepdims=True)).astype(np.float32))
    idx = MultiVectorIndex(dim=DIM, backend=backend, device="cpu",
                           doc_maxlen=24, n_centroids=16, ndocs=64)
    idx.add([torch.from_numpy(d) for d in docs[:30]])
    new_ids = idx.add([torch.from_numpy(d) for d in docs[30:]])
    assert list(new_ids) == list(range(30, 40))
    q = torch.from_numpy(docs[35][:4])
    _, i = idx.search(q, k=3)
    top = int(i[0])
    idx.delete([top])
    _, i2 = idx.search(q, k=3)
    assert top not in list(i2)
    assert idx.add([]).shape == (0,)


def test_docstore_delete_is_lazy_and_views_stay():
    rng = np.random.default_rng(6)
    docs = _docs(rng, 6)
    store = DocStore(DIM, 8, device="cpu")
    store.add([torch.from_numpy(d) for d in docs])
    view = store.padded()
    store.delete([1, 4])
    assert store.padded() is view
    np.testing.assert_array_equal(store.live, [1, 0, 1, 1, 0, 1])
    assert store.n_vectors() == sum(len(docs[i]) for i in (0, 2, 3, 5))
    for i, d in enumerate(store.docs_list()):
        np.testing.assert_array_equal(d.numpy(), docs[i])
    np.testing.assert_array_equal(store.doc(4).numpy(), docs[4])


def test_index_docs_views_equal_reference():
    for backend in ("flat", "hnsw", "plaid"):
        jidx, tidx, _ = _mutated(backend, seed=7, n=30, n_add=5,
                                 dead=(2,))
        td, jd = tidx.docs, jidx.docs
        assert len(td) == len(jd) == 35
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)


def test_cascade_doc_views_equal_reference():
    from repro.retrieval.cascade import CascadeIndex as JCascade
    from repro_torch.retrieval.cascade import CascadeIndex
    rng = np.random.default_rng(8)
    coarse, fine = _docs(rng, 7, 1, 3), _docs(rng, 7, 3, 6)
    j = JCascade(dim=DIM)
    t = CascadeIndex(dim=DIM, device="cpu")
    j.add(coarse, fine)
    t.add([torch.from_numpy(d) for d in coarse],
          [torch.from_numpy(d) for d in fine])
    for ours, theirs in ((t.coarse_docs, j.coarse_docs),
                         (t.fine_docs, j.fine_docs)):
        assert len(ours) == len(theirs) == 7
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), b)


def test_indexer_builds_hnsw_and_adds_after_build():
    """``Indexer.build`` with ``IndexSpec(backend="hnsw")``: the graph of
    the pooled rows, as a direct add of the same rows builds it; a later
    add through the index appends."""
    import repro_torch as rt
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    model = rt.init_colbert(rt.SMOKE, seed=0, device="cpu")
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "mutation", n_docs=12, n_queries=3, doc_len_mean=12, doc_len_std=3,
        seed=2), vocab_size=rt.SMOKE.trunk.vocab_size)
    docs = corpus.doc_token_batch(14)
    spec = rt.IndexSpec(backend="hnsw", hnsw_m=4, hnsw_ef_construction=16,
                        hnsw_candidates=32)
    indexer = rt.Indexer(model, index_spec=spec,
                         pooling_spec=rt.PoolingSpec("ward", 2),
                         encode_batch=4, device="cpu")
    idx, stats = indexer.build(docs[:8])
    assert idx.backend == "hnsw" and stats.n_docs == 8
    flat, counts, _ = indexer.encode_and_pool_counted(docs[:8])
    ref = MultiVectorIndex(dim=idx.dim, backend="hnsw", device="cpu",
                           **spec.params())
    ref.add_flat(flat, counts)
    assert ref._hnsw.graph == idx._hnsw.graph
    more = indexer.encode_and_pool(docs[8:])
    np.testing.assert_array_equal(idx.add(more), np.arange(8, 12))
    searcher = rt.Searcher(model, idx, encode_batch=4)
    S, I = searcher.search(corpus.query_token_batch(10), k=3)
    assert ((I >= 0) & (I < 12)).all() and np.isfinite(S).all()
