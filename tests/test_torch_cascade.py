"""The pooled cascade (``retrieval/cascade.py``) in the port against the
JAX package.

* A cascade built in both packages from the same pooled numpy vectors
  returns the same results.
* Artifacts both ways: a JAX cascade artifact loads in the port with
  equal payloads and searches the same, and the reverse; re-saving in
  the port gives the same payload bytes.
* ``Searcher.from_dir`` serves a cascade directory.
* ``build_cascade`` through the SMOKE encoder (f32, the JAX weights via
  ``params_from_jax``) against the reference's ``build_cascade``.

Tolerances: top-k ids equal tie-aware and scores to rtol 1e-5 /
atol 1e-5 on the same vectors (f32 dot products and sums in another
order); through the encoder (pooled vectors equal to ~1e-7) atol 1e-4.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.colbertv2 import SMOKE as J_SMOKE
from repro.core import persist as jpersist
from repro.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
from repro.models import colbert as jcol
from repro.retrieval.cascade import CascadeIndex as JCascade
from repro.retrieval.cascade import build_cascade as j_build_cascade
from repro.retrieval.searcher import Searcher as JSearcher
import repro_torch as rt
from repro_torch.core import persist
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.models import colbert as tcol
from repro_torch.retrieval.cascade import CascadeIndex, build_cascade

DIM = 16


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _levels(seed, n=60):
    rng = np.random.default_rng(seed)
    coarse = [_unit(rng, (int(rng.integers(1, 4)), DIM)) for _ in range(n)]
    fine = [_unit(rng, (int(rng.integers(3, 10)), DIM)) for _ in range(n)]
    return coarse, fine, _unit(rng, (5, 4, DIM))


def _pair(seed, **kw):
    coarse, fine, qs = _levels(seed)
    j = JCascade(dim=DIM, doc_maxlen=24, **kw)
    j.add(coarse, fine)
    t = CascadeIndex(dim=DIM, doc_maxlen=24, device="cpu", **kw)
    t.add([torch.from_numpy(v) for v in coarse],
          [torch.from_numpy(v) for v in fine])
    return j, t, qs


def _same(jres, tres, atol=1e-5):
    jS, jI = (np.asarray(a) for a in jres)
    tS, tI = tres
    assert tie_aware_mismatches(jI, jS, tI, tS, atol) == 0
    np.testing.assert_allclose(tS, jS, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("candidates,k", [(8, 5), (32, 10), (4, 12),
                                          (100, 70)])
def test_cascade_matches_jax(candidates, k):
    """Stage 1 keeps max(candidates, k) docs, capped at n_docs; k above
    n_docs pads with -inf / -1 on both sides."""
    j, t, qs = _pair(candidates + k, candidates=candidates)
    _same(j.search_batch(qs, k=k), t.search_batch(torch.from_numpy(qs), k=k))
    jS, jI = j.search(qs[0], k=k)
    tS, tI = t.search(torch.from_numpy(qs[0]), k=k)
    assert len(tI) == len(jI)
    assert (t.n_docs, t.n_vectors(), t.stage1_vectors()) == \
        (j.n_docs, j.n_vectors(), j.stage1_vectors())


def test_empty_cascade_and_mismatched_levels():
    t = CascadeIndex(dim=DIM, device="cpu")
    S, I = t.search_batch(torch.zeros((2, 3, DIM)), k=4)
    assert (I == -1).all() and np.isinf(S).all() and S.shape == (2, 4)
    with pytest.raises(ValueError):
        t.add([torch.zeros((1, DIM))], [])


def _payloads_equal(a_dir, b_dir):
    ma, mb = jpersist.read_manifest(a_dir), jpersist.read_manifest(b_dir)
    assert set(ma["payloads"]) == set(mb["payloads"])
    pa = jpersist.load_payloads(a_dir, ma, mmap=False)
    pb = jpersist.load_payloads(b_dir, mb, mmap=False)
    for name in pa:
        assert pa[name].dtype == pb[name].dtype, name
        assert pa[name].tobytes() == pb[name].tobytes(), name
    for key in ("kind", "dim", "coarse_factor", "fine_factor", "candidates",
                "doc_maxlen"):
        assert ma[key] == mb[key], key


def test_jax_cascade_artifact_serves_in_port(tmp_path):
    j, _, qs = _pair(3, candidates=8, coarse_factor=4, fine_factor=1)
    j.save(str(tmp_path / "jax"))
    t = persist.load_artifact(str(tmp_path / "jax"), device="cpu")
    assert isinstance(t, CascadeIndex)
    assert (t.coarse_factor, t.fine_factor, t.candidates) == (4, 1, 8)
    _same(j.search_batch(qs, k=5), t.search_batch(torch.from_numpy(qs), k=5))
    t.save(str(tmp_path / "port"))                 # re-saved by the port
    _payloads_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert isinstance(CascadeIndex.from_dir(str(tmp_path / "jax"),
                                            device="cpu"), CascadeIndex)


def test_port_cascade_artifact_serves_in_jax(tmp_path):
    j, t, qs = _pair(4, candidates=16)
    t.save(str(tmp_path / "port"), extra_meta={"note": "port"})
    j.save(str(tmp_path / "jax"))
    _payloads_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
    jt = jpersist.load_artifact(str(tmp_path / "port"))
    assert isinstance(jt, JCascade)
    _same(jt.search_batch(qs, k=6), t.search_batch(torch.from_numpy(qs), k=6))
    assert persist.read_manifest(str(tmp_path / "port"))["note"] == "port"


def test_artifact_kind_dispatch(tmp_path):
    j, t, _ = _pair(5)
    t.save(str(tmp_path / "c"))
    from repro_torch.core.index import MultiVectorIndex
    idx = MultiVectorIndex(dim=DIM, backend="flat", doc_maxlen=24,
                           device="cpu")
    idx.add([torch.from_numpy(_unit(np.random.default_rng(0), (3, DIM)))])
    idx.save(str(tmp_path / "i"))
    with pytest.raises(persist.IndexFormatError, match="cascade_index"):
        persist.load_cascade(str(tmp_path / "i"), device="cpu")
    with pytest.raises(persist.IndexFormatError, match="multi_vector_index"):
        persist.load_index(str(tmp_path / "c"), device="cpu")
    manifest = persist.read_manifest(str(tmp_path / "c"))
    persist.write_artifact(str(tmp_path / "s"),
                           dict(manifest, kind="sharded_index"), {})
    # dispatched to the sharded loader, which refuses a root without the
    # sharded keys
    with pytest.raises(persist.IndexFormatError, match="backend"):
        persist.load_artifact(str(tmp_path / "s"), device="cpu")


@pytest.fixture(scope="module")
def smoke_pair():
    jcfg = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tcfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(0), jcfg)
    model = tcol.ColBERT(tcfg, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "cascade", n_docs=80, n_queries=8, doc_len_mean=30, doc_len_std=10,
        seed=9), vocab_size=1024)
    docs = corpus.doc_token_batch(46)
    queries = corpus.query_token_batch(6)
    jc = j_build_cascade(params, jcfg, docs, candidates=16)
    jres = JSearcher(params, jcfg, jc).search(queries, k=10)
    tc = build_cascade(model, docs, candidates=16, device="cpu")
    return dict(model=model, queries=queries, jc=jc, jres=jres, tc=tc)


def test_build_cascade_matches_jax(smoke_pair):
    sp = smoke_pair
    jc, tc = sp["jc"], sp["tc"]
    assert (tc.coarse_factor, tc.fine_factor, tc.doc_maxlen, tc.dim) == \
        (jc.coarse_factor, jc.fine_factor, jc.doc_maxlen, jc.dim)
    np.testing.assert_array_equal(tc._coarse.offsets, jc._coarse.offsets)
    np.testing.assert_array_equal(tc._fine.offsets, jc._fine.offsets)
    for level in ("_coarse", "_fine"):            # pooled vectors
        np.testing.assert_allclose(
            getattr(tc, level).flat.numpy(),
            np.concatenate(getattr(jc, level).docs_list()), atol=1e-5)
    tres = rt.Searcher(sp["model"], tc).search(sp["queries"], k=10)
    _same(sp["jres"], tres, atol=1e-4)


def test_searcher_from_dir_serves_cascade(smoke_pair, tmp_path):
    sp = smoke_pair
    path = str(tmp_path / "cascade")
    sp["tc"].save(path)
    assert os.path.isfile(os.path.join(path, "manifest.json"))
    searcher = rt.Searcher.from_dir(sp["model"], path, device="cpu")
    assert isinstance(searcher.index, CascadeIndex)
    S, I = searcher.search(sp["queries"], k=10)
    S0, I0 = rt.Searcher(sp["model"], sp["tc"]).search(sp["queries"], k=10)
    np.testing.assert_array_equal(I, I0)
    np.testing.assert_array_equal(S, S0)
    _same(sp["jres"], (S, I), atol=1e-4)
