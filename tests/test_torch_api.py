"""The port's spec layer (``repro_torch/core/spec.py``) and ``Retriever``
facade (``repro_torch/api.py``) against the JAX package's, after
``tests/test_spec.py`` and ``tests/test_api.py``, at SMOKE size with the
same seeded weights (``params_from_jax``) and the same tokens.

* Each spec's ``to_dict()`` equals the reference's for the same fields,
  and each package's dict builds the other's spec.
* The manifest round trip both ways: ``manifest_meta_for`` gives the
  reference's entries, and each package reads back the other's.
* Validation, ``coerce``, the pooling and backend registries, and
  ``add_spec_args`` / ``spec_from_args`` (the same flags as the
  reference's).
* ``Retriever.build`` / ``load`` / ``search`` / ``add`` / ``delete`` for
  flat, plaid monolithic, plaid sharded and the cascade against the
  JAX ``Retriever``: flat and cascade built by both packages search
  the same; plaid artifacts (the codec is trained on the builder's own
  vectors) are built by one package and served by the other.
* ``make_colbert_index_step`` / ``make_colbert_search_step`` against
  the reference's.

Tolerances: ids, layouts and counts exact; rankings tie-aware; scores
``allclose`` at rtol 1e-5 / atol 1e-5 where both packages encode (f32
sums in another order), atol 1e-4 where one package serves the other's
plaid artifact (as ``tests/test_torch_persist.py``).
"""
import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.core import spec as JS
from repro_torch.core import persist
from repro_torch.core import spec as S
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus

RTOL = ATOL = 1e-5
ARTIFACT_ATOL = 1e-4


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
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "api", n_docs=36, n_queries=8, n_topics=4, doc_len_mean=22,
        doc_len_std=4, seed=5), vocab_size=tcfg.trunk.vocab_size)
    toks = corpus.doc_token_batch(tcfg.doc_maxlen - 2)
    q = corpus.query_token_batch(tcfg.query_maxlen - 2)[:4]
    return params, jcfg, model, toks, q


def _spec(cfg, backend, factor=2, shard_max=0, **over):
    return rt.RetrieverSpec(
        pooling=rt.PoolingSpec(method="ward", factor=factor),
        index=rt.IndexSpec.from_config(cfg, backend=backend, **over),
        shard=rt.ShardSpec(shard_max_vectors=shard_max))


def _jspec(spec):
    return JS.RetrieverSpec.from_dict(spec.to_dict())


def _same(S0, I0, S1, I1, atol=ATOL):
    S0, I0 = np.asarray(S0), np.asarray(I0)
    assert tie_aware_mismatches(I0, S0, I1, S1, atol) == 0
    np.testing.assert_allclose(S1, S0, rtol=RTOL, atol=atol)


def _json(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------------------------------
# Specs: the reference's dicts, both ways
# ---------------------------------------------------------------------------
SPEC_CASES = [
    ("PoolingSpec", {}),
    ("PoolingSpec", dict(method="kmeans", factor=3, ward_kernel="ref")),
    ("IndexSpec", {}),
    ("IndexSpec", dict(backend="hnsw", doc_maxlen=40, n_centroids=17,
                       quant_bits=4, nprobe=3, t_cs=0.125, ndocs=999,
                       hnsw_m=7, hnsw_ef_construction=33,
                       hnsw_candidates=555)),
    ("IndexSpec", dict(backend="cascade", coarse_factor=5, fine_factor=3,
                       candidates=48)),
    ("ShardSpec", {}),
    ("ShardSpec", dict(shard_max_vectors=524_288, probe_threads=3)),
    ("ServeSpec", {}),
    ("ServeSpec", dict(max_batch=8, max_wait_ms=1.5, k=5,
                       pipeline_depth=2, n_replicas=2)),
]


@pytest.mark.parametrize("name,kw", SPEC_CASES)
def test_spec_to_dict_equals_reference(name, kw):
    ours, theirs = getattr(S, name)(**kw), getattr(JS, name)(**kw)
    assert ours.to_dict() == theirs.to_dict()
    assert getattr(S, name).from_dict(theirs.to_dict()) == ours
    assert ours.replace(**kw) == ours


def test_retriever_spec_to_dict_equals_reference():
    spec = rt.RetrieverSpec(
        pooling=rt.PoolingSpec("sequential", 4),
        index=rt.IndexSpec(backend="flat", ndocs=64),
        shard=rt.ShardSpec(shard_max_vectors=1000, probe_threads=2),
        serve=rt.ServeSpec(max_batch=4))
    assert spec.to_dict() == _jspec(spec).to_dict()
    assert rt.RetrieverSpec().to_dict() == JS.RetrieverSpec().to_dict()
    assert rt.RetrieverSpec.from_dict(_json(spec.to_dict())) == spec
    assert spec.index.artifact_kind == "multi_vector_index"
    assert spec.index.params() == _jspec(spec).index.params()
    assert spec.index.generic_params() == _jspec(spec).index.generic_params()


@pytest.mark.parametrize("backend,shard_max", [
    ("flat", 0), ("flat", 64), ("hnsw", 0), ("hnsw", 64), ("plaid", 0),
    ("plaid", 64), ("cascade", 0)])
def test_manifest_roundtrip_both_ways(backend, shard_max):
    if backend == "cascade":
        index = rt.IndexSpec(backend="cascade", coarse_factor=5,
                             fine_factor=3, candidates=48, doc_maxlen=96)
    else:
        index = rt.IndexSpec(backend=backend, doc_maxlen=40, n_centroids=17,
                             quant_bits=4, nprobe=3, t_cs=0.125, ndocs=999)
    spec = rt.RetrieverSpec(pooling=rt.PoolingSpec("kmeans", 3), index=index,
                            shard=rt.ShardSpec(shard_max_vectors=shard_max,
                                               probe_threads=shard_max // 32))
    ours = _json(S.manifest_meta_for(spec))
    theirs = _json(JS.manifest_meta_for(_jspec(spec)))
    assert ours == theirs
    back = S.retriever_spec_from_manifest(theirs)
    assert (back.pooling, back.index, back.shard) == \
        (spec.pooling, spec.index, spec.shard)
    jback = JS.retriever_spec_from_manifest(ours)
    assert jback.to_dict() == back.to_dict()


def test_spec_validation():
    with pytest.raises(ValueError, match="bogus"):
        rt.IndexSpec.from_dict({"bogus": 1})
    with pytest.raises(ValueError, match="bogus"):
        rt.PoolingSpec.from_dict({"method": "ward", "bogus": 2})
    with pytest.raises(ValueError, match="bogus"):
        rt.RetrieverSpec.from_dict({"index": {"bogus": 1}})
    with pytest.raises(ValueError, match="unknown index params"):
        rt.IndexSpec.from_manifest_params("plaid", {"bogus": 3})
    with pytest.raises(TypeError):
        rt.IndexSpec().replace(bogus=1)
    for bad in (lambda: rt.PoolingSpec(factor=0),
                lambda: rt.PoolingSpec(method=""),
                lambda: rt.PoolingSpec(ward_kernel="x"),
                lambda: rt.ShardSpec(shard_max_vectors=-1),
                lambda: rt.ShardSpec(probe_threads=-1),
                lambda: rt.ServeSpec(max_batch=0)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="unknown backend"):
        rt.IndexSpec(backend="faiss")
    with pytest.raises(ValueError, match="sharded"):
        rt.RetrieverSpec(index=rt.IndexSpec(backend="cascade"),
                         shard=rt.ShardSpec(shard_max_vectors=10))
    with pytest.raises(ValueError, match="no retriever spec"):
        S.retriever_spec_from_manifest({"kind": "residual_codec"})


def test_coerce(setup):
    _, _, model, _, _ = setup
    ix = rt.IndexSpec(backend="flat")
    assert rt.RetrieverSpec.coerce(ix).index == ix
    pl = rt.PoolingSpec("kmeans", 3)
    assert rt.RetrieverSpec.coerce(pl).pooling == pl
    sh = rt.ShardSpec(shard_max_vectors=7)
    assert rt.RetrieverSpec.coerce(sh).shard == sh
    full = rt.RetrieverSpec(pooling=pl)
    assert rt.RetrieverSpec.coerce(full) is full
    cfg2 = dataclasses.replace(model.cfg, pool_factor=2)
    got = rt.RetrieverSpec.coerce({"index": {"backend": "flat"}}, cfg2)
    assert got.pooling == rt.PoolingSpec(method=cfg2.pool_method, factor=2)
    assert got.index == rt.IndexSpec(backend="flat")
    assert rt.RetrieverSpec.coerce(None, cfg2) == rt.RetrieverSpec.from_config(
        cfg2)
    with pytest.raises(TypeError):
        rt.RetrieverSpec.coerce(42)


# ---------------------------------------------------------------------------
# Registries and argparse
# ---------------------------------------------------------------------------
def test_pooling_registry():
    from repro_torch.core.pooling import pool_doc_embeddings
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 12, 8)).astype(np.float32))
    mask = torch.ones((2, 12), dtype=torch.bool)
    mask[1, 9:] = False
    for method in ("sequential", "ward"):
        got = rt.PoolingSpec(method=method, factor=2).apply(x, mask)
        want = pool_doc_embeddings(x, mask, 2, method)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    got = rt.PoolingSpec(method="ward", factor=1).apply(x, mask)
    for a, b in zip(got, pool_doc_embeddings(x, mask, 1, "none")):
        assert torch.equal(a, b)
    name = "torch-test-first-half"

    def first_half(x, mask, factor):
        m = np.asarray(mask, bool)
        rank = np.cumsum(m, axis=-1) - 1
        return np.asarray(x), m & (rank < np.ceil(
            m.sum(-1, keepdims=True) / factor))

    rt.register_pooling_strategy(name, first_half, overwrite=True)
    assert name in rt.pooling_methods()
    assert rt.pooling_methods()[:4] == JS.BUILTIN_POOL_METHODS
    assert S.pooling_strategy(name) is first_half
    _, pm = rt.PoolingSpec(method=name, factor=2).apply(x.numpy(), mask.numpy())
    assert pm.sum() == 6 + 5
    with pytest.raises(ValueError, match="already registered"):
        rt.register_pooling_strategy(name, first_half)
    with pytest.raises(ValueError, match="already registered"):
        rt.register_pooling_strategy("ward", first_half)
    with pytest.raises(KeyError):
        S.pooling_strategy("no-such-method")


def test_backend_registry():
    import repro_torch.api  # noqa: F401  (fills in the builders)
    assert rt.backend_names() == JS.backend_names()[:4]
    for b in ("flat", "hnsw", "plaid"):
        assert S.backend_info(b).artifact_kind == "multi_vector_index"
        assert S.backend_info(b).param_keys == JS.INDEX_PARAM_KEYS
    assert S.backend_info("cascade").artifact_kind == "cascade_index"
    assert S.backend_info("cascade").param_keys == JS.CASCADE_PARAM_KEYS
    for b in rt.backend_names():
        assert S.backend_info(b).builder is not None
    with pytest.raises(KeyError):
        S.backend_info("nope")
    with pytest.raises(ValueError, match="already registered"):
        rt.register_backend("flat", "multi_vector_index", ())


def test_add_spec_args_roundtrip():
    def parser(mod):
        ap = argparse.ArgumentParser()
        mod.add_spec_args(ap, mod.ServeSpec,
                          only=("max_batch", "max_wait_ms", "k"))
        mod.add_spec_args(ap, mod.PoolingSpec, prefix="pool-",
                          defaults={"factor": 2})
        mod.add_spec_args(ap, mod.ShardSpec)
        mod.add_spec_args(ap, mod.IndexSpec, prefix="index-")
        return ap

    ap, jap = parser(S), parser(JS)
    argv = ["--max-batch", "8", "--max-wait-ms", "1.5",
            "--pool-method", "kmeans", "--shard-max-vectors", "256",
            "--index-backend", "hnsw", "--index-t-cs", "0.5"]
    args = ap.parse_args(argv)
    assert vars(args) == vars(jap.parse_args(argv))
    assert [(a.dest, a.default) for a in ap._actions] == \
        [(a.dest, a.default) for a in jap._actions]
    serve = S.spec_from_args(rt.ServeSpec, args,
                             only=("max_batch", "max_wait_ms", "k"))
    assert serve == rt.ServeSpec(max_batch=8, max_wait_ms=1.5, k=10)
    assert S.spec_from_args(rt.PoolingSpec, args, prefix="pool_") == \
        rt.PoolingSpec(method="kmeans", factor=2)
    assert S.spec_from_args(rt.ShardSpec, args) == rt.ShardSpec(
        shard_max_vectors=256)
    assert S.spec_from_args(rt.IndexSpec, args, prefix="index_") == \
        rt.IndexSpec(backend="hnsw", t_cs=0.5)
    assert S.spec_from_args(rt.ShardSpec, args, shard_max_vectors=0) == \
        rt.ShardSpec()
    flags = {a.dest for a in ap._actions}
    assert "poll_interval_s" not in flags and "pipeline_depth" not in flags


# ---------------------------------------------------------------------------
# The facade against the JAX Retriever
# ---------------------------------------------------------------------------
def test_retriever_flat_against_jax(setup):
    params, jcfg, model, toks, q = setup
    spec = _spec(model.cfg, "flat")
    r = rt.Retriever.build(model, toks[:30], spec, device="cpu")
    jr = repro.Retriever.build(params, jcfg, toks[:30], _jspec(spec))
    S1, I1 = r.search(q, k=5)
    _same(*jr.search(q, k=5), S1, I1)
    assert r.stats.n_vectors_stored == jr.stats.n_vectors_stored
    assert r.stats.n_vectors_raw == jr.stats.n_vectors_raw
    assert r.stats.index_bytes == jr.stats.index_bytes
    ids = r.add(toks[30:])
    np.testing.assert_array_equal(ids, jr.add(toks[30:]))
    assert r.stats.n_docs == len(toks)
    victim = int(I1[0][0])
    r.delete([victim])
    jr.delete([victim])
    S2, I2 = r.search(q, k=5)
    _same(*jr.search(q, k=5), S2, I2)
    assert victim not in I2[0].tolist()
    assert r.rankings(q, k=5) == jr.rankings(q, k=5)
    S3, I3 = r.search_batch(q, k=5)
    np.testing.assert_array_equal(I2, I3)


@pytest.mark.parametrize("shard_max", [0, 160])
def test_retriever_plaid_artifacts_both_ways(setup, tmp_path, shard_max):
    """plaid monolithic and sharded: each package builds, the other
    serves the artifact (``Retriever.load``, the spec read back) with the
    builder's results; both builds give the same layout and counts."""
    params, jcfg, model, toks, q = setup
    spec = _spec(model.cfg, "plaid", shard_max=shard_max, n_centroids=16)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    r = rt.Retriever.build(model, toks, spec, out_dir=tdir, device="cpu")
    jr = repro.Retriever.build(params, jcfg, toks, _jspec(spec), out_dir=jdir)
    for f in ("n_docs", "n_vectors_raw", "n_vectors_stored", "n_shards"):
        assert getattr(r.stats, f) == getattr(jr.stats, f), f
    if shard_max:
        assert isinstance(r.index, rt.ShardedIndex) and r.index.n_shards > 1
        assert r.index.doc_base == [int(b) for b in jr.index.doc_base]
    S1, I1 = r.search(q, k=5)
    jl = repro.Retriever.load(params, jcfg, tdir)
    assert jl.spec.to_dict() == _jspec(r.spec).to_dict()
    _same(*jl.search(q, k=5), S1, I1, atol=ARTIFACT_ATOL)
    tl = rt.Retriever.load(model, jdir, device="cpu")
    assert (tl.spec.pooling, tl.spec.index, tl.spec.shard) == \
        (spec.pooling, spec.index, spec.shard)
    assert tl.stats.n_docs == jr.stats.n_docs
    _same(*jr.search(q, k=5), *tl.search(q, k=5), atol=ARTIFACT_ATOL)
    r2 = rt.Retriever.load(model, tdir, device="cpu")
    assert r2.spec == r.spec.replace(serve=rt.ServeSpec())
    assert r2.stats.index_bytes == r.stats.index_bytes
    np.testing.assert_array_equal(r2.search(q, k=5)[1], I1)
    ids = r2.add(toks[:3])
    np.testing.assert_array_equal(ids, np.arange(len(toks), len(toks) + 3))
    r2.delete([int(I1[0][0])])
    assert int(I1[0][0]) not in r2.search(q[:1], k=5)[1][0].tolist()


def test_retriever_cascade_against_jax(setup, tmp_path):
    params, jcfg, model, toks, q = setup
    spec = _spec(model.cfg, "cascade", coarse_factor=4, fine_factor=2,
                 candidates=16)
    out = str(tmp_path / "casc")
    r = rt.Retriever.build(model, toks[:30], spec, out_dir=out, device="cpu")
    jr = repro.Retriever.build(params, jcfg, toks[:30], _jspec(spec))
    _same(*jr.search(q, k=5), *r.search(q, k=5))
    for f in ("n_docs", "n_vectors_raw", "n_vectors_stored", "index_bytes"):
        assert getattr(r.stats, f) == getattr(jr.stats, f), f
    assert _json(persist.read_manifest(out))["params"] == \
        spec.index.generic_params()
    jl = repro.Retriever.load(params, jcfg, out)
    assert jl.spec.index.to_dict() == spec.index.to_dict()
    _same(*jl.search(q, k=5), *r.search(q, k=5))
    np.testing.assert_array_equal(r.add(toks[30:]), jr.add(toks[30:]))
    _same(*jr.search(q, k=5), *r.search(q, k=5))
    with pytest.raises(NotImplementedError):
        r.delete([0])
    r.warmup([1, 2], k=5)


def test_retriever_equals_indexer_paths(setup):
    """The facade returns exactly what the Indexer / Searcher it wraps
    return, monolithic and streamed."""
    _, _, model, toks, q = setup
    for shard_max in (0, 160):
        spec = _spec(model.cfg, "flat", shard_max=shard_max)
        r = rt.Retriever.build(model, toks, spec, device="cpu")
        ix = rt.Indexer(model, index_spec=spec.index,
                        pooling_spec=spec.pooling, device="cpu")
        idx, _ = (ix.build_streaming(toks, shard_max_vectors=shard_max)
                  if shard_max else ix.build(toks))
        S0, I0 = rt.Searcher(model, idx).search(q, k=5)
        S1, I1 = r.search(q, k=5)
        np.testing.assert_array_equal(I0, I1)
        np.testing.assert_array_equal(S0, S1)


def test_retriever_load_refuses_specless_artifact(tmp_path):
    rng = np.random.default_rng(0)
    codec = rt.MultiVectorIndex(dim=16, device="cpu", n_centroids=4)
    v = rng.normal(size=(40, 16)).astype(np.float32)
    codec.add([v / np.linalg.norm(v, axis=-1, keepdims=True)])
    persist.save_codec(codec._plaid.codec, str(tmp_path / "codec"))
    model = rt.init_colbert(rt.SMOKE, device="cpu")
    with pytest.raises(rt.IndexFormatError, match="no retriever spec"):
        rt.Retriever.load(model, str(tmp_path / "codec"), device="cpu")


def test_custom_pooling_strategy_through_facade(setup):
    _, _, model, toks, q = setup
    name = "torch-api-first-half"

    def first_half(x, mask, factor):
        m = np.asarray(mask.cpu(), bool)
        rank = np.cumsum(m, axis=-1) - 1
        return x.cpu().numpy(), m & (rank < np.ceil(
            m.sum(-1, keepdims=True) / factor))

    rt.register_pooling_strategy(name, first_half, overwrite=True)
    r = rt.Retriever.build(model, toks, rt.RetrieverSpec(
        pooling=rt.PoolingSpec(method=name, factor=2),
        index=rt.IndexSpec.from_config(model.cfg, backend="flat")),
        device="cpu")
    base = rt.Retriever.build(model, toks, _spec(model.cfg, "flat", factor=1),
                              device="cpu")
    assert 0 < r.stats.n_vectors_stored < base.stats.n_vectors_stored
    _, I = r.search(q, k=5)
    assert I.shape == (len(q), 5) and (I >= 0).all()


def test_searcher_encode_deprecated_and_warmup(setup):
    _, _, model, toks, q = setup
    s = rt.Searcher(model, None)
    ref = s.encode_queries(q[:1])
    with pytest.warns(DeprecationWarning, match="encode_queries"):
        legacy = s.encode(q[:1])
    assert torch.equal(ref, legacy)
    r = rt.Retriever.build(model, toks, _spec(model.cfg, "plaid",
                                              n_centroids=16),
                           device="cpu")
    r.warmup([1, 3], k=5)
    r.warmup(2, k=5)
    assert r.index.warm_shapes(s.encode_queries(q), k=5) is None


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def test_colbert_index_step_against_reference(setup):
    from repro.launch.steps import make_colbert_index_step as jstep
    params, jcfg, model, toks, _ = setup
    jc = dataclasses.replace(jcfg, pool_factor=2)
    tc = dataclasses.replace(model.cfg, pool_factor=2)
    batch = {"doc_tokens": toks[:6]}
    jp, jm = jstep(jc)(params, {"doc_tokens": jax.numpy.asarray(toks[:6])})
    tp, tm = rt.make_colbert_index_step(tc, device="cpu")(model, batch)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["einsum", "blocked"])
def test_colbert_search_step_against_reference(setup, impl):
    from repro.launch.steps import make_colbert_search_step as jstep
    params, jcfg, model, toks, q = setup
    jc = dataclasses.replace(jcfg, maxsim_impl=impl, maxsim_block=8)
    tc = dataclasses.replace(model.cfg, maxsim_impl=impl)
    pooled, pmask = rt.make_colbert_index_step(
        dataclasses.replace(tc, pool_factor=2), device="cpu")(
        model, {"doc_tokens": toks[:24]})
    batch = {"q_tokens": q, "doc_vecs": pooled.numpy(),
             "doc_mask": pmask.numpy()}
    jS, jI = jstep(jc, k=5)(params, {k: jax.numpy.asarray(v)
                                     for k, v in batch.items()})
    tS, tI = rt.make_colbert_search_step(tc, k=5, device="cpu")(model, batch)
    _same(jS, jI, tS.numpy(), tI.numpy())
    with pytest.raises(ValueError):
        rt.make_colbert_search_step(dataclasses.replace(tc, maxsim_impl="x"),
                                    device="cpu")
