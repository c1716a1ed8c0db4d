"""Index artifacts between the two packages (``core/persist.py``,
``FORMAT_VERSION = 1``).

* A JAX-written plaid artifact, with docs deleted before ``save``, loads
  in the port with payloads equal to what the JAX loader reads, bit for
  bit, and searches the same on every path: the device candidate path,
  the host probe path with and without the prune, the dense
  corpus-wide fallback, and ``packed_rerank=False``.
* The reverse: a port-written artifact loads and searches the same in
  the JAX package; re-saving a JAX artifact in the port gives the same
  payload bytes.
* Flat artifacts both ways.
* The format errors of ``tests/test_persist.py``.
* The whole slice through the entry points: ``Indexer.build(out_dir)``
  -> ``Searcher.from_dir`` -> ``search``, port against JAX on the same
  seeded weights.

Tolerances: ids equal tie-aware and scores to rtol 1e-5, atol 1e-4 —
the same codes on both sides, f32 dot products and sums in another
order (and, for the f32 rerank, a reconstruction decoded in torch
instead of XLA, equal to ~1e-7).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import persist as jpersist
from repro.core.index import MultiVectorIndex as JIndex
from repro_torch.core import persist
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.core.persist import (FORMAT_VERSION, MANIFEST_NAME,
                                      IndexFormatError, load_index)

DIM = 16
RTOL, ATOL = 1e-5, 1e-4


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _docs(rng, n, lo=2, hi=6):
    return [_unit(rng, (int(rng.integers(lo, hi)), DIM)) for _ in range(n)]


def _jax_artifact(tmp_path, n=200, deleted=(3, 17, 42), backend="plaid",
                  seed=21, **kw):
    """A JAX index with a few docs deleted, saved; -> (jidx, path, rng)."""
    rng = np.random.default_rng(seed)
    kw = dict(dict(doc_maxlen=24, n_centroids=32, nprobe=2, ndocs=16), **kw)
    jidx = JIndex(dim=DIM, backend=backend, **kw)
    jidx.add(_docs(rng, n))
    jidx.delete([d for d in deleted if d < n])
    path = str(tmp_path / f"jax_{backend}_{n}")
    jidx.save(path, extra_meta={"pool": {"method": "ward", "factor": 2}})
    return jidx, path, rng


def _assert_same_results(jidx, tidx, qs, k=7):
    jS, jI = jidx.search_batch(qs, k=k)
    tS, tI = tidx.search_batch(torch.from_numpy(qs), k=k)
    jS, jI = np.asarray(jS), np.asarray(jI)
    assert tie_aware_mismatches(jI, jS, tI, tS, ATOL) == 0
    np.testing.assert_allclose(tS, jS, rtol=RTOL, atol=ATOL)
    return tS, tI


def test_jax_artifact_payloads_load_bit_for_bit(tmp_path):
    jidx, path, _ = _jax_artifact(tmp_path)
    manifest = persist.read_manifest(path)
    assert manifest == jpersist.read_manifest(path)
    for mmap in (True, False):
        ours = persist.load_payloads(path, manifest, mmap=mmap)
        theirs = jpersist.load_payloads(path, manifest, mmap=mmap)
        assert sorted(ours) == sorted(theirs)
        for name in theirs:
            assert ours[name].dtype == theirs[name].dtype, name
            np.testing.assert_array_equal(ours[name], theirs[name])
    tidx = load_index(path, device="cpu")
    jl = jpersist.load_index(path)
    tp, jp = tidx._plaid, jl._plaid
    np.testing.assert_array_equal(tp.codes.numpy().view(np.uint32),
                                  np.asarray(jp.codes))
    np.testing.assert_array_equal(tp.assignments.numpy(),
                                  np.asarray(jp.assignments))
    for a in ("vec2doc", "doc_offsets"):
        np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
    np.testing.assert_array_equal(tp.ivf.ids, jp.ivf.ids)
    np.testing.assert_array_equal(tp.ivf.offsets, jp.ivf.offsets)
    for a in ("centroids", "cutoffs", "values"):
        np.testing.assert_array_equal(getattr(tp.codec, a).numpy(),
                                      np.asarray(getattr(jp.codec, a)))
    assert tidx.deleted == jl.deleted == {3, 17, 42}
    assert (tidx.n_docs, tidx.n_vectors()) == (jl.n_docs, jl.n_vectors())
    params = {k: getattr(tidx, k) for k in manifest["params"]}
    assert params == manifest["params"]


@pytest.mark.parametrize("path_kind,kw", [
    ("device", dict()),
    ("host_pruned", dict(probe_kernel="host")),
    ("host_unpruned", dict(probe_kernel="host", ndocs=64, n_centroids=64,
                           nprobe=1)),
    ("recon_rerank", dict(packed_rerank=False)),
    ("dense", dict(n=30, ndocs=8192)),
])
def test_jax_artifact_searches_the_same(tmp_path, path_kind, kw):
    kw = dict(kw)
    toggles = {k: kw.pop(k) for k in ("probe_kernel", "packed_rerank")
               if k in kw}
    jidx, path, rng = _jax_artifact(tmp_path, **kw)
    tidx = load_index(path, device="cpu")
    for idx in (jidx, tidx):
        for key, value in toggles.items():
            setattr(idx, key, value)
    qs = _unit(rng, (6, 4, DIM))
    use_dev, _ = tidx._probe_plan(4)
    assert use_dev == (path_kind == "device" or path_kind == "recon_rerank")
    cand, cmask = tidx.candidates(torch.from_numpy(qs))
    width = cand.shape[1]
    if path_kind == "dense":
        assert width >= tidx.n_docs
    else:
        assert width < tidx.n_docs
    if path_kind == "host_pruned":
        assert int(cmask.sum(1).max()) == tidx.ndocs
    if path_kind == "host_unpruned":
        assert width <= tidx.ndocs
    _, tI = _assert_same_results(jidx, tidx, qs)
    assert not np.isin(tI, [3, 17, 42]).any()
    assert (tI >= 0).all()


def test_port_artifact_loads_and_searches_in_jax(tmp_path):
    jidx, path, rng = _jax_artifact(tmp_path)
    tidx = load_index(path, device="cpu")
    out = str(tmp_path / "port")
    manifest = tidx.save(out, extra_meta={"pool": {"method": "ward",
                                                   "factor": 2}})
    jm = jpersist.read_manifest(out)
    assert jm["params"] == jpersist.read_manifest(path)["params"]
    assert jm["codec_bits"] == 2 and jm["generation"] == 1
    assert persist.artifact_bytes(manifest) == jpersist.artifact_bytes(path)
    # the port re-writes the JAX artifact's payloads byte for byte
    a = jpersist.load_payloads(path, jpersist.read_manifest(path))
    b = jpersist.load_payloads(out, jm)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name])
    jl = jpersist.load_index(out)
    qs = _unit(rng, (5, 4, DIM))
    for probe in ("auto", "host"):
        jl.probe_kernel = tidx.probe_kernel = probe
        _assert_same_results(jl, tidx, qs)


def test_port_built_artifact_searches_the_same_in_jax(tmp_path):
    """A port-built (own codec) index, saved: JAX serves it with the
    port's results."""
    rng = np.random.default_rng(5)
    tidx = MultiVectorIndex(dim=DIM, device="cpu", doc_maxlen=24,
                            n_centroids=32, nprobe=2, ndocs=16)
    tidx.add([torch.from_numpy(v) for v in _docs(rng, 150)])
    path = str(tmp_path / "built")
    tidx.save(path)
    jl = jpersist.load_index(path)
    assert jl.backend == "plaid" and jl.n_docs == 150
    np.testing.assert_array_equal(np.asarray(jl._plaid.codes).view(np.int32),
                                  tidx._plaid.codes.numpy())
    _assert_same_results(jl, tidx, _unit(rng, (6, 4, DIM)))
    assert tidx.save(path)["generation"] == 2


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_flat_artifact_both_ways(tmp_path, direction):
    jidx, path, rng = _jax_artifact(tmp_path, n=60, backend="flat")
    qs = _unit(rng, (5, 4, DIM))
    tidx = load_index(path, device="cpu")
    assert tidx.backend == "flat" and tidx.deleted == {3, 17, 42}
    np.testing.assert_array_equal(tidx._store.flat.numpy(),
                                  np.asarray(jidx._store._flat[
                                      :jidx._store._n_vectors])[
                                      np.repeat(jidx._store.live,
                                                jidx._store.doc_lengths())])
    if direction == "port_to_jax":
        out = str(tmp_path / "port_flat")
        tidx.save(out)
        jidx = jpersist.load_index(out)
    _, tI = _assert_same_results(jidx, tidx, qs)
    assert not np.isin(tI, [3, 17, 42]).any()


# ------------------------------------------------------------ format errors
def _saved_flat(tmp_path, n=12):
    rng = np.random.default_rng(3)
    idx = MultiVectorIndex(dim=DIM, backend="flat", device="cpu")
    idx.add([torch.from_numpy(v) for v in _docs(rng, n, 4, 20)])
    path = tmp_path / "idx"
    idx.save(str(path))
    return path


def _payload_file(path, name):
    manifest = json.loads((path / MANIFEST_NAME).read_text())
    return path / manifest["payloads"][name]["file"]


def test_missing_manifest_raises(tmp_path):
    with pytest.raises(IndexFormatError, match="manifest"):
        load_index(str(tmp_path), device="cpu")


@pytest.mark.parametrize("mmap", [True, False])
def test_truncated_payload_raises(tmp_path, mmap):
    path = _saved_flat(tmp_path)
    fp = _payload_file(path, "flat")
    with open(fp, "r+b") as fh:
        fh.truncate(os.path.getsize(fp) - 64)
    with pytest.raises(IndexFormatError, match="flat"):
        load_index(str(path), mmap=mmap, device="cpu")


def test_missing_payload_file_raises(tmp_path):
    path = _saved_flat(tmp_path)
    os.remove(_payload_file(path, "offsets"))
    with pytest.raises(IndexFormatError, match="offsets"):
        load_index(str(path), device="cpu")


@pytest.mark.parametrize("key", ["dim", "backend", "params", "payloads"])
def test_missing_manifest_key_raises(tmp_path, key):
    path = _saved_flat(tmp_path)
    mf = path / MANIFEST_NAME
    manifest = json.loads(mf.read_text())
    del manifest[key]
    mf.write_text(json.dumps(manifest))
    with pytest.raises(IndexFormatError):
        load_index(str(path), device="cpu")


def test_bumped_format_version_raises(tmp_path):
    path = _saved_flat(tmp_path)
    mf = path / MANIFEST_NAME
    manifest = json.loads(mf.read_text())
    manifest["format_version"] = FORMAT_VERSION + 1
    mf.write_text(json.dumps(manifest))
    with pytest.raises(IndexFormatError, match="format_version"):
        load_index(str(path), device="cpu")


def test_shape_tamper_raises(tmp_path):
    path = _saved_flat(tmp_path)
    mf = path / MANIFEST_NAME
    manifest = json.loads(mf.read_text())
    manifest["payloads"]["flat"]["shape"][0] += 1
    mf.write_text(json.dumps(manifest))
    with pytest.raises(IndexFormatError, match="does not match"):
        load_index(str(path), device="cpu")


# ------------------------------------------------- the slice, end to end
@pytest.fixture(scope="module")
def slice_dirs(tmp_path_factory):
    """JAX and port builds of one corpus with the same seeded weights and
    codec, each written with ``Indexer.build(out_dir=...)``."""
    from repro.configs.colbertv2 import SMOKE as J_SMOKE
    from repro.core.spec import IndexSpec as JIndexSpec
    from repro.core.spec import PoolingSpec as JPoolingSpec
    from repro.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    from repro.models import colbert as jcol
    from repro.retrieval.indexer import Indexer as JIndexer
    import repro_torch as rt
    from repro_torch.core.quantization import ResidualCodec
    from repro_torch.models import colbert as tcol

    kw = dict(doc_maxlen=48, n_centroids=32, nprobe=4, ndocs=64)
    jcfg = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tcfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(1), jcfg)
    model = tcol.ColBERT(tcfg, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "persist", n_docs=160, n_queries=12, doc_len_mean=30,
        doc_len_std=10, seed=4), vocab_size=1024)
    docs = corpus.doc_token_batch(46)
    root = tmp_path_factory.mktemp("slice")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jindexer = JIndexer(params, jcfg, index_spec=JIndexSpec(**kw),
                        pooling_spec=JPoolingSpec("ward", 2))
    jidx, jstats = jindexer.build(docs, out_dir=jdir)
    c = jidx._plaid.codec
    codec = ResidualCodec(*(torch.tensor(np.asarray(a)) for a in
                            (c.centroids, c.cutoffs, c.values)), c.bits)
    indexer = rt.Indexer(model, index_spec=rt.IndexSpec(**kw),
                         pooling_spec=rt.PoolingSpec("ward", 2), device="cpu")
    tidx, tstats = indexer.build(docs, codec=codec, out_dir=tdir)
    return dict(params=params, jcfg=jcfg, model=model, jdir=jdir, tdir=tdir,
                jstats=jstats, tstats=tstats, tidx=tidx,
                queries=corpus.query_token_batch(6))


def test_slice_build_out_dir_writes_artifact_and_stats(slice_dirs):
    p = slice_dirs
    jm, tm = (persist.read_manifest(p[k]) for k in ("jdir", "tdir"))
    assert tm["pool"] == jm["pool"] == {"method": "ward", "factor": 2}
    for key in ("kind", "backend", "dim", "n_docs", "params", "codec_bits"):
        assert tm[key] == jm[key], key
    assert {n: (e["dtype"], e["shape"][1:]) for n, e in
            tm["payloads"].items()} == \
        {n: (e["dtype"], e["shape"][1:]) for n, e in jm["payloads"].items()}
    stats = json.loads(open(os.path.join(p["tdir"], "stats.json")).read())
    assert stats["index_bytes"] == persist.artifact_bytes(tm)
    assert p["tstats"].index_bytes == persist.artifact_bytes(tm)
    assert p["tstats"].index_bytes == persist.serialized_nbytes(p["tidx"])
    assert stats["n_vectors_stored"] == p["jstats"].n_vectors_stored


@pytest.mark.parametrize("served_by", ["port", "jax"])
def test_slice_from_dir_search_equals_jax(slice_dirs, served_by):
    """``Searcher.from_dir`` of the port's artifact against the JAX
    searcher of its own: the two builds differ only where a residual
    sits on a codec cutoff (``test_torch_slice.py``), so ids agree
    tie-aware within 0.05 and scores to 0.05. Served by JAX, the port's
    artifact gives the port's results to the stated tolerance."""
    from repro.retrieval.searcher import Searcher as JSearcher
    import repro_torch as rt
    p = slice_dirs
    tS, tI = rt.Searcher.from_dir(p["model"], p["tdir"],
                                  device="cpu").search(p["queries"], k=10)
    if served_by == "port":
        jS, jI = JSearcher.from_dir(p["params"], p["jcfg"],
                                    p["jdir"]).search(p["queries"], k=10)
        assert tie_aware_mismatches(jI, jS, tI, tS, 0.05) == 0
        np.testing.assert_allclose(tS, jS, atol=0.05)
    else:
        jS, jI = JSearcher.from_dir(p["params"], p["jcfg"],
                                    p["tdir"]).search(p["queries"], k=10)
        assert tie_aware_mismatches(jI, jS, tI, tS, ATOL) == 0
        np.testing.assert_allclose(tS, jS, rtol=RTOL, atol=ATOL)
    assert (tI >= 0).all()
