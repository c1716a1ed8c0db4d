"""Per-document k-means and sequential pooling in the port against the
JAX package, and the ``kmeans_assign`` kernel's plain version against
the Pallas kernel (interpret mode) and its JAX reference.

Tolerances:
* ``kmeans_assign``: ids equal; best sims to the reference test's
  tolerance (``tests/test_kernels.py``: rtol 2e-4 in f32, 2e-2 in bf16,
  atol 1e-2), since the two frameworks sum the dot products in another
  order.
* ``kmeans_cluster_batch``, ``sequential_assign`` and the ``kmeans`` /
  ``sequential`` branches of ``pool_doc_embeddings``: assignments and
  masks equal; pooled rows allclose at 1e-5 (f32 segment sums in
  another order).
* The slice through ``Indexer.build`` (flat backend, the SMOKE encoder
  in f32 with the JAX weights): stored vector counts equal per doc; top-k
  ids equal tie-aware and scores to rtol 1e-5 / atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.colbertv2 import SMOKE as J_SMOKE
from repro.core.kmeans import kmeans_cluster as j_kmeans_cluster
from repro.core.kmeans import kmeans_cluster_batch as j_kmeans_cluster_batch
from repro.core.pooling import pool_doc_embeddings as j_pool
from repro.core.pooling import sequential_assign as j_sequential_assign
from repro.core.pooling import vector_counts as j_vector_counts
from repro.core.spec import IndexSpec as JIndexSpec
from repro.core.spec import PoolingSpec as JPoolingSpec
from repro.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
from repro.kernels.kmeans_assign.ops import kmeans_assign as j_kmeans_assign
from repro.kernels.kmeans_assign.ref import kmeans_assign_ref as j_assign_ref
from repro.models import colbert as jcol
from repro.retrieval.indexer import Indexer as JIndexer
from repro.retrieval.searcher import Searcher as JSearcher
import repro_torch as rt
from repro_torch.core.kmeans import kmeans_cluster, kmeans_cluster_batch
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.core.pooling import (pool_doc_embeddings, sequential_assign,
                                      vector_counts)
from repro_torch.core.spec import POOL_METHODS, PORTED_POOL_METHODS
from repro_torch.kernels import launch_counts
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.models import colbert as tcol

N, D = J_SMOKE.doc_maxlen, J_SMOKE.proj_dim       # SMOKE pooling shapes


def _tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 2e-4


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n,k,dim", [(100, 8, 64), (257, 32, 128),
                                     (64, 5, 32)])
def test_kmeans_assign_plain_matches_jax(n, k, dim, dtype):
    rng = np.random.default_rng(n + k)
    x = jnp.asarray(rng.normal(size=(n, dim)), dtype)
    c = jnp.asarray(rng.normal(size=(k, dim)), dtype)
    km = jnp.asarray(np.arange(k) < max(k - 2, 1))
    ja, js = j_kmeans_assign(x, c, km, block_n=64)       # interpret mode
    ra, rs = j_assign_ref(x, c, km)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt)
    tc = torch.tensor(np.asarray(c.astype(jnp.float32))).to(tdt)
    before = launch_counts()["kmeans_assign"]
    a, s = kmeans_assign(tx, tc, torch.tensor(np.asarray(km)))
    assert launch_counts()["kmeans_assign"] == before      # CPU: plain
    assert a.dtype == torch.int32 and s.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    for want in (js, rs):
        np.testing.assert_allclose(s.numpy(), np.asarray(want),
                                   rtol=_tol(dtype), atol=1e-2)


def test_kmeans_assign_all_masked_and_batched():
    """A row with every cluster masked gets index 0 and -inf (the
    reference's iota-min), and the batched call equals per-doc calls."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 20, 16)).astype(np.float32)
    c = rng.normal(size=(3, 6, 16)).astype(np.float32)
    km = rng.random((3, 6)) < 0.6
    km[1] = False
    a, s = kmeans_assign(torch.from_numpy(x), torch.from_numpy(c),
                         torch.from_numpy(km))
    assert (a[1] == 0).all() and torch.isinf(s[1]).all()
    ja, js = j_assign_ref(jnp.asarray(x[1]), jnp.asarray(c[1]),
                          jnp.asarray(km[1]))
    np.testing.assert_array_equal(np.asarray(ja), 0)
    for b in range(3):
        ab, sb = kmeans_assign(torch.from_numpy(x[b]), torch.from_numpy(c[b]),
                               torch.from_numpy(km[b]))
        assert torch.equal(ab, a[b]) and torch.equal(sb, s[b])


def _batch(seed, B=6):
    """x [B, N, D] with padded masks: full, empty, ragged, with gaps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    n_valid = rng.integers(1, N + 1, B)
    n_valid[0], n_valid[1] = N, 0
    mask = np.arange(N)[None, :] < n_valid[:, None]
    mask[2, ::5] = False                     # masked gaps inside a doc
    return x, mask


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_kmeans_cluster_batch_matches_jax(factor):
    x, mask = _batch(factor)
    want = np.asarray(j_kmeans_cluster_batch(jnp.asarray(x),
                                             jnp.asarray(mask), factor))
    got = kmeans_cluster_batch(torch.from_numpy(x), torch.from_numpy(mask),
                               factor)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < N // factor + 1).all()


def test_kmeans_cluster_one_doc_matches_jax():
    x, mask = _batch(11)
    k_max = N // 2 + 1
    for b in (0, 3):
        k_t = int(mask[b].sum()) // 2 + 1
        want = np.asarray(j_kmeans_cluster(jnp.asarray(x[b]),
                                           jnp.asarray(mask[b]), k_t, k_max))
        got = kmeans_cluster(torch.from_numpy(x[b]),
                             torch.from_numpy(mask[b]), k_t, k_max)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_sequential_assign_matches_jax(factor):
    _, mask = _batch(20 + factor)
    want = np.asarray(j_sequential_assign(jnp.asarray(mask), factor))
    got = sequential_assign(torch.from_numpy(mask), factor)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["kmeans", "sequential"])
@pytest.mark.parametrize("factor", [2, 3, 4])
def test_pool_doc_embeddings_matches_jax(method, factor):
    x, mask = _batch(30 + factor)
    jp, jm = j_pool(jnp.asarray(x), jnp.asarray(mask), factor, method)
    tp, tm = pool_doc_embeddings(torch.from_numpy(x), torch.from_numpy(mask),
                                 factor, method)
    assert tuple(tp.shape) == (6, N, D) and tuple(tm.shape) == (6, N)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)
    assert vector_counts(torch.from_numpy(mask), tm) == \
        j_vector_counts(jnp.asarray(mask), jm)
    counts = tm.sum(1).numpy()
    n_valid = mask.sum(1)
    if method == "sequential":               # exactly ceil(n / f) vectors
        np.testing.assert_array_equal(counts, -(-n_valid // factor))
    else:                                    # at most n // f + 1 clusters
        assert (counts <= n_valid // factor + 1).all()


def test_every_pool_method_is_ported():
    assert PORTED_POOL_METHODS == POOL_METHODS
    x, mask = _batch(40, B=3)
    for method in POOL_METHODS:
        spec = rt.PoolingSpec(method, 2)
        p, m = spec.apply(torch.from_numpy(x), torch.from_numpy(mask))
        assert tuple(p.shape) == (3, N, D) and m.dtype == torch.bool


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
        "kmeans-slice", n_docs=96, n_queries=8, doc_len_mean=30,
        doc_len_std=10, seed=5), vocab_size=1024)
    return dict(params=params, jcfg=jcfg, model=model,
                docs=corpus.doc_token_batch(46),
                queries=corpus.query_token_batch(6))


@pytest.mark.parametrize("method", ["kmeans", "sequential"])
def test_slice_flat_index_matches_jax(smoke_pair, method):
    """``Indexer.build`` -> ``Searcher.search`` with each new pooling
    method on the flat backend, port against JAX on the same weights."""
    sp = smoke_pair
    jindexer = JIndexer(sp["params"], sp["jcfg"],
                        index_spec=JIndexSpec(backend="flat", doc_maxlen=48),
                        pooling_spec=JPoolingSpec(method, 2), encode_batch=32)
    jidx, jstats = jindexer.build(sp["docs"])
    jS, jI = JSearcher(sp["params"], sp["jcfg"], jidx).search(sp["queries"],
                                                              k=10)
    indexer = rt.Indexer(sp["model"],
                         index_spec=rt.IndexSpec(backend="flat",
                                                 doc_maxlen=48),
                         pooling_spec=rt.PoolingSpec(method, 2),
                         encode_batch=32, device="cpu")
    tidx, tstats = indexer.build(sp["docs"])
    tS, tI = rt.Searcher(sp["model"], tidx).search(sp["queries"], k=10)
    assert (tstats.n_vectors_raw, tstats.n_vectors_stored) == \
        (jstats.n_vectors_raw, jstats.n_vectors_stored)
    np.testing.assert_array_equal(tidx._store.doc_lengths(),
                                  jidx._store.doc_lengths())
    assert tie_aware_mismatches(np.asarray(jI), np.asarray(jS), tI, tS,
                                1e-4) == 0
    np.testing.assert_allclose(tS, np.asarray(jS), rtol=1e-5, atol=1e-4)
