"""The port's streaming build (``Indexer.build_streaming``) against the
JAX package's, after ``tests/test_index_pipeline.py``, at SMOKE size
with the same seeded weights (carried by ``params_from_jax``) and the
same tokens.

* Both packages stream the corpus into the same shards: equal shard
  boundaries, doc ids, per-shard and raw vector counts; the flat shards
  search the same.
* Pipelined and serial builds write byte-equal artifacts (payloads
  compared under canonical names: file names carry a random token).
* The pooled buffer stays within ``shard_max_vectors`` plus one batch's
  yield; the raw count equals a count of the emit mask; a flush failure
  is raised in the caller, pipelined or not.
* ``EncodedDocs`` builds equal token builds; ``build_streaming``
  refuses it.
* The segment sums' one-hot route (the card's, the same bits every
  run) equals ``index_add_`` (the CPU's) within 1e-6, for the three
  sums of a build (pooled means, IVF k-means, codec values).
* A plaid stream: later shards carry the first shard's codec, a
  reloaded shard gives it back, and the JAX package serves the port's
  streamed artifact with the port's results.

Tolerances: layouts, ids and counts exact; scores ``allclose`` at
rtol 1e-5 / atol 1e-5, rankings tie-aware (two encoders, f32 sums in
another order); the JAX loader on the port's plaid artifact, atol 1e-4
as in ``tests/test_torch_persist.py`` (the same codes, decoded and
summed in another order); within the port, artifacts byte-equal.
"""
import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.retrieval.indexer import EncodedDocs

_TOKEN = re.compile(r"\.[0-9a-f]{8}\.npy")
CAP = 512
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    from repro.configs.colbertv2 import SMOKE as J_SMOKE
    from repro.models import colbert as jcol
    from repro_torch.models import colbert as tcol
    jcfg = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tcfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(0), jcfg)
    model = tcol.ColBERT(tcfg, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(0)
    toks = rng.integers(3, tcfg.trunk.vocab_size,
                        size=(90, tcfg.doc_maxlen - 2)).astype(np.int32)
    return params, jcfg, model, toks


def _indexer(model, backend="flat", **kw):
    return rt.Indexer(model, index_spec=rt.IndexSpec.from_config(
        model.cfg, backend=backend, ndocs=4096, **kw),
        pooling_spec=rt.PoolingSpec("ward", 2), encode_batch=32,
        device="cpu")


def _jindexer(params, jcfg, backend="flat"):
    from repro.core.spec import IndexSpec, PoolingSpec
    from repro.retrieval.indexer import Indexer
    return Indexer(params, jcfg, encode_batch=32,
                   index_spec=IndexSpec.from_config(jcfg, backend=backend,
                                                    ndocs=4096),
                   pooling_spec=PoolingSpec("ward", 2))


def _canonical_artifact(root):
    """{canonical relpath: bytes or token-stripped json} (stats.json
    records timings, not content, so it is left out)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name == "stats.json":
                continue
            path = os.path.join(dirpath, name)
            rel = _TOKEN.sub(".npy", os.path.relpath(path, root))
            with open(path, "rb") as fh:
                blob = fh.read()
            out[rel] = (_TOKEN.sub(".npy", blob.decode())
                        if name.endswith(".json") else blob)
    return out


def _queries(model, n=4, seed=1):
    q = np.random.default_rng(seed).normal(
        size=(n, 8, model.cfg.proj_dim)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_stream_matches_jax_layout_and_search(setup):
    params, jcfg, model, toks = setup
    ts, tst = _indexer(model).build_streaming(toks, shard_max_vectors=CAP)
    js, jst = _jindexer(params, jcfg).build_streaming(
        toks, shard_max_vectors=CAP)
    assert tst.n_shards == jst.n_shards >= 2
    assert ts.doc_base == [int(b) for b in js.doc_base]
    assert [s.n_docs for s in ts.shards] == [s.n_docs for s in js.shards]
    assert [s.n_vectors() for s in ts.shards] == \
        [s.n_vectors() for s in js.shards]
    for f in ("n_docs", "n_vectors_raw", "n_vectors_stored",
              "peak_buffered_vectors", "max_batch_vectors", "index_bytes"):
        assert getattr(tst, f) == getattr(jst, f), f
    qs = _queries(model)
    S, I = ts.search_batch(qs, k=6)
    jS, jI = js.search_batch(qs, k=6)
    jS, jI = np.asarray(jS), np.asarray(jI)
    assert tie_aware_mismatches(jI, jS, I, S, ATOL) == 0
    np.testing.assert_allclose(S, jS, rtol=RTOL, atol=ATOL)


def test_pipelined_flush_matches_serial(setup, tmp_path):
    _, _, model, toks = setup
    dirs, stats = {}, {}
    for pipe in (False, True):
        d = str(tmp_path / f"pipe_{pipe}")
        _, st = _indexer(model, backend="plaid").build_streaming(
            toks, shard_max_vectors=CAP, out_dir=d, pipeline=pipe)
        dirs[pipe], stats[pipe] = d, st
        assert st.pipelined is pipe
    a, b = stats[False], stats[True]
    for f in ("n_docs", "n_vectors_raw", "n_vectors_stored", "n_shards",
              "peak_buffered_vectors", "max_batch_vectors", "index_bytes"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.n_shards >= 2
    ca, cb = (_canonical_artifact(dirs[p]) for p in (False, True))
    assert sorted(ca) == sorted(cb)
    assert sum(rel.endswith(".npy") for rel in ca) > 0
    for rel in ca:
        assert ca[rel] == cb[rel], f"artifact drift in {rel}"


def test_pipelined_in_memory_build_parity(setup):
    _, _, model, toks = setup
    res = {}
    for pipe in (False, True):
        sharded, st = _indexer(model).build_streaming(
            toks, shard_max_vectors=CAP, pipeline=pipe)
        res[pipe] = (st.n_shards, sharded.search_batch(_queries(model), k=5))
    assert res[False][0] == res[True][0]
    for ra, rb in zip(res[False][1], res[True][1]):
        np.testing.assert_array_equal(ra, rb)


def test_buffer_bound_and_raw_count(setup):
    """The pooled buffer peaks within cap + one batch's yield; shards
    other than the last hold at most cap + one doc; the raw count is the
    emit mask's, and the monolithic build reports the same."""
    from repro_torch.models.colbert import emit_mask_docs, prepare_doc_tokens
    _, _, model, toks = setup
    cap = 300
    batches = [toks[lo:lo + 16] for lo in range(0, len(toks), 16)]
    sharded, st = _indexer(model).build_streaming(iter(batches),
                                                  shard_max_vectors=cap)
    assert st.peak_buffered_vectors <= cap + st.max_batch_vectors
    assert st.n_shards == sharded.n_shards >= 3
    for s in sharded.shards[:-1]:
        assert s.n_vectors() <= cap + model.cfg.doc_maxlen
    t, attn = prepare_doc_tokens(torch.from_numpy(toks), model.cfg.doc_maxlen)
    raw = int(emit_mask_docs(t, attn, model.cfg.mask_punctuation).sum())
    _, mono = _indexer(model).build(toks)
    assert st.n_vectors_raw == mono.n_vectors_raw == raw
    assert st.n_vectors_stored == mono.n_vectors_stored
    np.testing.assert_array_equal(sharded.shard_of(np.arange(len(toks))),
                                  np.repeat(np.arange(sharded.n_shards),
                                            [s.n_docs for s in
                                             sharded.shards]))


@pytest.mark.parametrize("pipeline", [True, False])
def test_flush_failure_propagates(setup, tmp_path, monkeypatch, pipeline):
    _, _, model, toks = setup

    def boom(self, *a, **kw):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(rt.MultiVectorIndex, "save", boom)
    with pytest.raises(RuntimeError, match="disk on fire"):
        _indexer(model).build_streaming(
            toks, shard_max_vectors=CAP, out_dir=str(tmp_path / "boom"),
            pipeline=pipeline)
    with pytest.raises(ValueError):
        _indexer(model).build_streaming(toks, shard_max_vectors=0)


def test_encoded_docs_build_equals_token_build(setup):
    _, _, model, toks = setup
    enc = EncodedDocs.encode(model, toks, encode_batch=32)
    assert enc.n_docs == len(toks) and len(enc.batches) == 3
    a, sa = _indexer(model).build(toks)
    b, sb = _indexer(model).build(enc)
    assert (sa.n_vectors_raw, sa.n_vectors_stored, sa.index_bytes) == \
        (sb.n_vectors_raw, sb.n_vectors_stored, sb.index_bytes)
    np.testing.assert_array_equal(a._store.flat.numpy(),
                                  b._store.flat.numpy())
    with pytest.raises(TypeError, match="EncodedDocs"):
        _indexer(model).build_streaming(enc, shard_max_vectors=CAP)


def test_plaid_stream_shares_codec_and_serves_in_jax(setup, tmp_path):
    """The first shard trains the codec, later shards carry it, reloaded
    shards give it back; ``Searcher.from_dir`` serves the artifact, and
    the JAX package's loader reads it with the port's results."""
    from repro.core import persist as jpersist
    params, jcfg, model, toks = setup
    out = str(tmp_path / "art")
    sharded, st = _indexer(model, backend="plaid", n_centroids=16) \
        .build_streaming(toks, shard_max_vectors=CAP, out_dir=out)
    assert st.n_shards >= 2
    codecs = [s._plaid.codec for s in sharded.shards]
    for c in codecs[1:]:
        for a in ("centroids", "cutoffs", "values"):
            torch.testing.assert_close(getattr(c, a), getattr(codecs[0], a),
                                       rtol=0, atol=0)
    with open(os.path.join(out, "stats.json")) as fh:
        js = json.load(fh)
    assert js["n_shards"] == st.n_shards
    assert js["peak_buffered_vectors"] == st.peak_buffered_vectors
    assert rt.load_artifact(out, device="cpu").n_docs == len(toks)
    searcher = rt.Searcher.from_dir(model, out, device="cpu")
    assert isinstance(searcher.index, rt.ShardedIndex)
    qs = _queries(model)
    S, I = searcher.index.search_batch(qs, k=6)
    S0, I0 = sharded.search_batch(qs, k=6)
    np.testing.assert_array_equal(I, I0)
    np.testing.assert_array_equal(S, S0)
    assert len(searcher.index.last_probe_s) == st.n_shards
    jS, jI = jpersist.load_artifact(out).search_batch(qs, k=6)
    jS, jI = np.asarray(jS), np.asarray(jI)
    assert tie_aware_mismatches(jI, jS, I, S, 1e-4) == 0
    np.testing.assert_allclose(S, jS, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("shape,n", [((300, 16), 40), ((5000,), 64),
                                     ((0, 3), 4), ((50, 2, 3), 200)])
def test_ordered_segment_sum_matches_index_add(shape, n):
    """The card's route sums each segment in one fixed order (so builds
    write the same bytes every run); it must equal ``index_add_``."""
    from repro_torch.core.segment import batched_segment_sum, segment_sum
    rng = np.random.default_rng(len(shape) + n)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, n, size=shape[0]))
    a = segment_sum(x, seg, n, ordered=True)
    b = segment_sum(x, seg, n, ordered=False)
    assert a.shape == b.shape == (n,) + shape[1:] and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert torch.equal(a, segment_sum(x, seg, n, ordered=True))
    if len(shape) == 2 and shape[0]:
        xb = x.reshape(4, -1, shape[1]) if shape[0] % 4 == 0 else x[None]
        ab = seg.reshape(xb.shape[:2]) % 7
        w = torch.from_numpy(rng.random(xb.shape[:2]) > 0.3)
        got = batched_segment_sum(xb, ab, w, 7, ordered=True)
        want = batched_segment_sum(xb, ab, w, 7, ordered=False)
        for g, t in zip(got, want):
            assert g.shape == t.shape
            torch.testing.assert_close(g, t, rtol=1e-6, atol=1e-6)


def test_build_sums_take_the_ordered_route_alike(setup, monkeypatch):
    """A build whose three segment sums take the card's ordered route
    (forced on the CPU) stores what the ``index_add_`` build stores,
    within 1e-6, with the same per-doc counts."""
    import functools
    import repro_torch.core.kmeans as K
    import repro_torch.core.pooling as P
    import repro_torch.core.quantization as Q
    from repro_torch.core.segment import batched_segment_sum, segment_sum
    _, _, model, toks = setup
    ix = _indexer(model, backend="plaid", n_centroids=16)
    a, _ = ix.build(toks[:40])
    for mod in (K, Q):
        monkeypatch.setattr(mod, "segment_sum",
                            functools.partial(segment_sum, ordered=True))
    monkeypatch.setattr(P, "batched_segment_sum", functools.partial(
        batched_segment_sum, ordered=True))
    b, _ = ix.build(toks[:40])
    np.testing.assert_array_equal(np.diff(a._plaid.doc_offsets),
                                  np.diff(b._plaid.doc_offsets))
    for name in ("centroids", "cutoffs", "values"):
        torch.testing.assert_close(getattr(b._plaid.codec, name),
                                   getattr(a._plaid.codec, name),
                                   rtol=1e-6, atol=1e-6)
