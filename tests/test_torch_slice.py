"""The whole slice — ``Indexer.build`` (encode -> Ward f=2 -> PLAID)
then ``Searcher.search`` — in the port against the JAX reference, on a
corpus where the device candidate plan holds (256 docs, ndocs=64,
nprobe=4) with the same parameters and the reference's codec.

The encoder runs in f32 (bf16 is held to its own tolerance in
test_torch_encoder.py), so pooled vectors agree to ~1e-7. Tolerances:
vector counts equal; top-k ids equal tie-aware; scores within 1e-4 for
at least 95% of the results and within 0.05 for all. The codec's
cutoffs are quantiles of the very residuals it encodes, so some
residuals sit exactly on a cutoff and a 1e-7 difference flips one
dimension's bucket — a few percent of rows (asserted), each moving a
doc score by a few hundredths at most.

Also: the port's own centroids and codec, trained in torch from the
reference's initial rows, agree with the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.colbertv2 import SMOKE as J_SMOKE
from repro.core.ivf import train_centroids as j_train_centroids
from repro.core.quantization import train_codec as j_train_codec
from repro.core.spec import IndexSpec as JIndexSpec
from repro.core.spec import PoolingSpec as JPoolingSpec
from repro.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
from repro.models import colbert as jcol
from repro.retrieval.indexer import Indexer as JIndexer
from repro.retrieval.searcher import Searcher as JSearcher
import repro_torch as rt
from repro_torch.core.ivf import train_centroids
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.core.quantization import ResidualCodec, train_codec
from repro_torch.models import colbert as tcol

KW = dict(doc_maxlen=48, n_centroids=32, nprobe=4, ndocs=64)


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tcfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(0), jcfg)
    model = tcol.ColBERT(tcfg, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "slice", n_docs=256, n_queries=16, doc_len_mean=30, doc_len_std=10,
        seed=3), vocab_size=1024)
    docs = corpus.doc_token_batch(46)
    queries = corpus.query_token_batch(6)
    jindexer = JIndexer(params, jcfg, index_spec=JIndexSpec(**KW),
                        pooling_spec=JPoolingSpec("ward", 2))
    jidx, jstats = jindexer.build(docs)
    jS, jI = JSearcher(params, jcfg, jidx).search(queries, k=10)
    c = jidx._plaid.codec
    codec = ResidualCodec(*(torch.tensor(np.asarray(a)) for a in
                            (c.centroids, c.cutoffs, c.values)), c.bits)
    indexer = rt.Indexer(model, index_spec=rt.IndexSpec(**KW),
                         pooling_spec=rt.PoolingSpec("ward", 2), device="cpu")
    tidx, tstats = indexer.build(docs, codec=codec)
    tS, tI = rt.Searcher(model, tidx).search(queries, k=10)
    return dict(jindexer=jindexer, jidx=jidx, jstats=jstats, jS=jS, jI=jI,
                indexer=indexer, tidx=tidx, tstats=tstats, tS=tS, tI=tI,
                docs=docs)


def test_slice_vector_counts_equal(slice_pair):
    j, t = slice_pair["jstats"], slice_pair["tstats"]
    assert (t.n_docs, t.n_vectors_raw, t.n_vectors_stored) == \
        (j.n_docs, j.n_vectors_raw, j.n_vectors_stored)
    assert t.n_vectors_stored < t.n_vectors_raw / 2 + t.n_docs
    assert abs(t.vector_reduction - j.vector_reduction) < 1e-12


def test_slice_topk_equal_tie_aware(slice_pair):
    p = slice_pair
    assert p["tI"].shape == p["jI"].shape == (16, 10)
    assert (p["tI"] >= 0).all()
    assert tie_aware_mismatches(p["jI"], p["jS"], p["tI"], p["tS"], 0.05) == 0
    close = np.isclose(p["tS"], p["jS"], rtol=0, atol=1e-4)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(p["tS"], p["jS"], atol=0.05)


def test_slice_encoded_rows_match_except_cutoff_ties(slice_pair):
    jp, tp = slice_pair["jidx"]._plaid, slice_pair["tidx"]._plaid
    np.testing.assert_array_equal(tp.assignments.numpy(),
                                  np.asarray(jp.assignments))
    differ = (tp.codes.numpy() != np.asarray(jp.codes).view(np.int32)).any(1)
    assert differ.mean() < 0.03, differ.mean()
    np.testing.assert_array_equal(tp.doc_offsets, jp.doc_offsets)


def test_slice_trained_centroids_and_codec_match_reference(slice_pair):
    flat, counts, _ = slice_pair["indexer"].encode_and_pool_counted(
        slice_pair["docs"])
    jflat = np.concatenate(slice_pair["jindexer"].encode_and_pool(
        slice_pair["docs"]))
    np.testing.assert_allclose(flat.numpy(), jflat, atol=1e-5)
    k = KW["n_centroids"]
    init = np.asarray(jax.random.permutation(jax.random.PRNGKey(0),
                                             len(jflat))[:k])
    jcen = np.asarray(j_train_centroids(jflat, k))
    tcen = train_centroids(torch.from_numpy(jflat), k,
                           init_idx=torch.tensor(init))
    np.testing.assert_allclose(tcen.numpy(), jcen, atol=1e-4)
    jcodec = j_train_codec(jnp.asarray(jflat), jnp.asarray(jcen), bits=2)
    tcodec = train_codec(torch.from_numpy(jflat), torch.tensor(jcen),
                         bits=2)
    np.testing.assert_allclose(tcodec.cutoffs.numpy(),
                               np.asarray(jcodec.cutoffs), atol=1e-5)
    np.testing.assert_allclose(tcodec.values.numpy(),
                               np.asarray(jcodec.values), atol=1e-5)


def test_slice_own_codec_build_and_plain_search(slice_pair):
    """The port trains its own codec (seeded torch draws) and its search
    through the kernels' plain versions returns the same ranking."""
    indexer = slice_pair["indexer"]
    idx, stats = indexer.build(slice_pair["docs"])
    assert stats.n_vectors_stored == slice_pair["tstats"].n_vectors_stored
    q = np.asarray(slice_pair["docs"][:4, :6])
    searcher = rt.Searcher(indexer.model, idx)
    S, I = searcher.search(q, k=5)
    S1, I1 = searcher.search(q, k=5, impl="ref")
    np.testing.assert_array_equal(I, I1)
    assert np.isfinite(S).all()
