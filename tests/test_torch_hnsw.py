"""The port's hnsw backend (``core/hnsw.py``, ``MultiVectorIndex`` with
``backend="hnsw"``, its artifacts) against the JAX reference.

The graph is host numpy in both packages, built from the same float32
vectors with the same seeded level draws: the graph (``graph``,
``levels``, ``entry``), the token-probe ids and the candidate slates
must be equal exactly. The stage-2 rerank runs the port's
``maxsim_rerank`` plain version here: scores to rtol 1e-5 / atol 1e-4
(f32 dot products and sums in another order), top-k ids equal
tie-aware.
"""
import numpy as np
import pytest
import torch

from repro.core import persist as jpersist
from repro.core.hnsw import HNSW as JHNSW
from repro.core.index import MultiVectorIndex as JIndex
from repro_torch.core import persist
from repro_torch.core.hnsw import HNSW
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.core.spec import IndexSpec

DIM = 16
RTOL, ATOL = 1e-5, 1e-4
KW = dict(doc_maxlen=24, hnsw_m=6, hnsw_ef_construction=32,
          hnsw_candidates=48)


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _docs(rng, n, lo=2, hi=7):
    return [_unit(rng, (int(rng.integers(lo, hi)), DIM)) for _ in range(n)]


def _pair(seed=0, n=60, n_add=12, dead=(4, 19, 61), **kw):
    """The same docs added, then more added and some deleted, in both
    packages -> (jidx, tidx, rng)."""
    rng = np.random.default_rng(seed)
    kw = dict(KW, **kw)
    jidx = JIndex(dim=DIM, backend="hnsw", **kw)
    tidx = MultiVectorIndex(dim=DIM, backend="hnsw", device="cpu", **kw)
    for batch in (_docs(rng, n), _docs(rng, n_add)):
        if not len(batch):
            continue
        ids = jidx.add(batch)
        np.testing.assert_array_equal(
            tidx.add([torch.from_numpy(d) for d in batch]), ids)
    jidx.delete(list(dead))
    tidx.delete(list(dead))
    return jidx, tidx, rng


def _same_graph(j, t):
    assert t.levels == j.levels
    assert t.entry == j.entry and t.max_level == j.max_level
    assert t.graph == j.graph
    assert t.deleted == j.deleted
    np.testing.assert_array_equal(t.vectors, j.vectors)


def _same_results(jidx, tidx, qs, q_mask=None, k=7):
    jS, jI = jidx.search_batch(qs, k=k, q_mask=q_mask)
    tS, tI = tidx.search_batch(torch.from_numpy(qs), k=k, q_mask=None
                               if q_mask is None else torch.from_numpy(q_mask))
    jS, jI = np.asarray(jS), np.asarray(jI)
    assert tie_aware_mismatches(jI, jS, tI, tS, ATOL) == 0
    np.testing.assert_allclose(tS, jS, rtol=RTOL, atol=ATOL)
    return tS, tI


def test_hnsw_copy_builds_the_reference_graph():
    rng = np.random.default_rng(3)
    x = _unit(rng, (300, DIM))
    j, t = JHNSW(DIM, m=6, ef_construction=32), HNSW(DIM, m=6,
                                                     ef_construction=32)
    for lo, hi in ((0, 200), (200, 300)):
        np.testing.assert_array_equal(t.add(x[lo:hi]), j.add(x[lo:hi]))
    t.delete([5, 77])
    j.delete([5, 77])
    _same_graph(j, t)
    q = _unit(rng, (20, DIM))
    np.testing.assert_array_equal(t.probe_tokens(q, 9), j.probe_tokens(q, 9))
    assert t.nbytes() == j.nbytes()


def test_index_graph_and_token_probes_equal_reference():
    jidx, tidx, rng = _pair()
    _same_graph(jidx._hnsw, tidx._hnsw)
    np.testing.assert_array_equal(tidx._hnsw_vec2doc, jidx._hnsw_vec2doc)
    q = _unit(rng, (24, DIM))
    np.testing.assert_array_equal(tidx._hnsw.probe_tokens(q, 8),
                                  jidx._hnsw.probe_tokens(q, 8))
    assert tidx.deleted == jidx.deleted
    assert tidx.nbytes() == jidx.nbytes()
    assert tidx.n_vectors() == jidx.n_vectors()


@pytest.mark.parametrize("masked", [False, True])
def test_hnsw_slates_equal_reference(masked):
    jidx, tidx, rng = _pair(1)
    qs = _unit(rng, (5, 4, DIM))
    q_mask = None
    if masked:
        q_mask = np.ones((5, 4), bool)
        q_mask[0, 1] = q_mask[3, :] = False
    jc, jm = jidx.candidates(qs, q_mask)
    tc, tm = tidx.candidates(torch.from_numpy(qs), None if q_mask is None
                             else torch.from_numpy(q_mask))
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert tc.shape[1] < tidx.n_docs          # the indexed rerank
    assert not np.isin(tc.numpy()[tm.numpy()], [4, 19, 61]).any()
    if masked:
        assert tm.numpy()[3].sum() == 0


@pytest.mark.parametrize("masked", [False, True])
def test_hnsw_search_equals_reference(masked):
    jidx, tidx, rng = _pair(2)
    qs = _unit(rng, (6, 5, DIM))
    q_mask = None
    if masked:
        q_mask = np.ones((6, 5), bool)
        q_mask[1, 2:] = False
    tS, tI = _same_results(jidx, tidx, qs, q_mask)
    assert not np.isin(tI, [4, 19, 61]).any()
    # the rerank is the exact MaxSim of the flat backend, restricted to
    # the slate
    cand, cmask = tidx.candidates(torch.from_numpy(qs), None if q_mask is
                                  None else torch.from_numpy(q_mask))
    flat = MultiVectorIndex(dim=DIM, backend="flat", device="cpu",
                            doc_maxlen=24)
    flat.add(tidx.docs)
    exact = flat.rerank(torch.from_numpy(qs), cand, cmask, None if q_mask is
                        None else torch.from_numpy(q_mask))
    np.testing.assert_allclose(
        np.sort(tS, axis=1)[:, ::-1],
        np.sort(exact.numpy(), axis=1)[:, ::-1][:, :tS.shape[1]],
        rtol=RTOL, atol=ATOL)


def test_hnsw_dense_fallback_equals_reference():
    """A slate as wide as the corpus takes the all-pairs scan."""
    jidx, tidx, rng = _pair(5, n=20, n_add=4, dead=(2,),
                            hnsw_candidates=4096)
    qs = _unit(rng, (3, 4, DIM))
    cand, _ = tidx.candidates(torch.from_numpy(qs))
    assert cand.shape[1] >= tidx.n_docs
    _, cand_t = tidx.scored_candidates(torch.from_numpy(qs))
    assert cand_t is None
    _same_results(jidx, tidx, qs)


def test_hnsw_search_one_query():
    jidx, tidx, rng = _pair(6)
    q = _unit(rng, (4, DIM))
    jS, jI = jidx.search(q, k=5)
    tS, tI = tidx.search(torch.from_numpy(q), k=5)
    assert tie_aware_mismatches(np.asarray(jI)[None], np.asarray(jS)[None],
                                tI[None], tS[None], ATOL) == 0
    np.testing.assert_allclose(tS, jS, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_hnsw_artifacts_both_ways(tmp_path, direction):
    jidx, tidx, rng = _pair(7)
    qs = _unit(rng, (5, 4, DIM))
    path = str(tmp_path / direction)
    if direction == "jax_to_port":
        jidx.save(path)
        loaded = persist.load_index(path, device="cpu")
        _same_graph(jidx._hnsw, loaded._hnsw)
        _same_results(jidx, loaded, qs)
        np.testing.assert_array_equal(loaded._hnsw_vec2doc,
                                      jidx._hnsw_vec2doc)
    else:
        manifest = tidx.save(path)
        assert manifest == jpersist.read_manifest(path)
        loaded = jpersist.load_index(path)
        _same_graph(loaded._hnsw, tidx._hnsw)
        _same_results(loaded, tidx, qs)
        assert loaded.deleted == tidx.deleted
    # the same payload bytes from either package's writer
    ours = persist.index_payloads(tidx)[1]
    theirs = jpersist.index_payloads(jidx)[1]
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        np.testing.assert_array_equal(ours[name], theirs[name])


def test_hnsw_add_delete_after_load_equals_reference(tmp_path):
    """Build, add, delete, save, load, then add and delete again and
    search, in both packages (post-load level draws restart from the
    seed in both)."""
    jidx, tidx, rng = _pair(8)
    tidx.save(str(tmp_path / "t"))
    jidx.save(str(tmp_path / "j"))
    tl = persist.load_index(str(tmp_path / "t"), device="cpu")
    jl = jpersist.load_index(str(tmp_path / "j"))
    more = _docs(rng, 6)
    np.testing.assert_array_equal(
        tl.add([torch.from_numpy(d) for d in more]), jl.add(more))
    for idx in (tl, jl):
        idx.delete([0, tl.n_docs - 1])
    _same_graph(jl._hnsw, tl._hnsw)
    qs = _unit(rng, (5, 4, DIM))
    _, tI = _same_results(jl, tl, qs)
    assert not np.isin(tI, [0, 4, 19, 61, tl.n_docs - 1]).any()


def test_indexspec_builds_hnsw_through_params():
    spec = IndexSpec(backend="hnsw", hnsw_m=6, hnsw_ef_construction=32,
                     hnsw_candidates=64)
    assert {k: spec.params()[k] for k in ("hnsw_m", "hnsw_ef_construction",
                                          "hnsw_candidates")} == \
        dict(hnsw_m=6, hnsw_ef_construction=32, hnsw_candidates=64)
    idx = MultiVectorIndex(dim=DIM, backend="hnsw", device="cpu",
                           **spec.params())
    assert (idx.hnsw_m, idx.hnsw_ef_construction, idx.hnsw_candidates) == \
        (6, 32, 64)
    from repro.core.spec import IndexSpec as JIndexSpec
    jspec = JIndexSpec(backend="hnsw")
    for key in ("hnsw_m", "hnsw_ef_construction", "hnsw_candidates"):
        assert getattr(IndexSpec(), key) == getattr(jspec, key)
    with pytest.raises(ValueError):
        IndexSpec(backend="hnsw", hnsw_m=0)
