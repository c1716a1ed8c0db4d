"""The compaction of a pooled batch (``repro_torch.core.pooling``
``compact_pooled_begin`` / ``compact_pooled_finish`` /
``compaction_transfer_stats``) and the indexer's one-batch-behind loop
over it, against the JAX package's.

* ``finish(begin(...))`` on seeded numpy batches: the per-doc arrays
  bitwise equal to ``repro.core.pooling``'s (same dtype, same rows in
  the same order), empty documents and an all-empty batch included, and
  the transfer stats equal the reference's;
* over Ward-pooled batches at f = 2, 3 and 4: the compact share of the
  padded bytes at most 1/f + 1/64 (``benchmarks/index_bench.py``'s
  gate), equal in both packages;
* ``compact_pooled_flat`` (the port's tuple form, ``compact_pooled``
  before it took the reference's list) unchanged: the boolean gather's
  rows and counts, bit for bit;
* ``Indexer.encode_and_pool_counted`` (pipelined) on the SMOKE encoder
  in f32 with the JAX weights (``params_from_jax``): rows, per-doc
  counts and raw count bitwise those of a serial loop compacting each
  batch with ``compact_pooled_flat``; against the JAX indexer, counts and raw
  count equal and rows within 1e-6 (f32 sums in another order), for a
  ragged last batch and for one batch; a host pooling strategy (arrays)
  takes the synchronous path with the same result;
* ``build_streaming``: pipelined and serial shards byte-equal, with the
  counts of the JAX package's streaming build.
"""
import dataclasses
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.colbertv2 import SMOKE as J_SMOKE
from repro.core import pooling as jpool
from repro.core.spec import IndexSpec as JIndexSpec
from repro.core.spec import PoolingSpec as JPoolingSpec
from repro.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
from repro.models import colbert as jcol
from repro.retrieval.indexer import Indexer as JIndexer
import repro_torch as rt
from repro_torch.core import pooling as tpool
from repro_torch.core.persist import read_manifest
from repro_torch.models import colbert as tcol

ROWS_ATOL = 1e-6          # pooled rows, torch vs XLA on the CPU


def _batch(seed, B, N, d, p_valid, empty=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, d)).astype(np.float32)
    m = rng.random((B, N)) < p_valid
    for b in empty:
        m[b] = False
    return x, m


CASES = {
    "mixed": (0, 6, 9, 8, 0.5, ()),
    "empty_docs": (1, 5, 7, 4, 0.6, (0, 3)),
    "all_empty": (2, 4, 6, 4, 0.5, (0, 1, 2, 3)),
    "one_doc_full": (3, 1, 5, 3, 1.1, ()),
}


@pytest.fixture
def fresh_stats():
    jpool.compaction_transfer_stats(reset=True)
    tpool.compaction_transfer_stats(reset=True)
    yield
    jpool.compaction_transfer_stats(reset=True)
    tpool.compaction_transfer_stats(reset=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_begin_finish_bitwise_reference(case, fresh_stats):
    x, m = _batch(*CASES[case])
    want = jpool.compact_pooled_finish(
        jpool.compact_pooled_begin(jnp.asarray(x), jnp.asarray(m)))
    ticket = tpool.compact_pooled_begin(torch.from_numpy(x),
                                        torch.from_numpy(m))
    got = tpool.compact_pooled_finish(ticket)
    assert len(got) == len(want) == x.shape[0]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert tpool.compaction_transfer_stats() == \
        jpool.compaction_transfer_stats()
    # the ticket's device form: the same rows, counts alone accounted
    rows, counts = ticket.device_rows()
    np.testing.assert_array_equal(rows.numpy(), np.concatenate(want))
    np.testing.assert_array_equal(counts, m.sum(1))


def test_transfer_stats_accumulate_and_reset(fresh_stats):
    for case in ("mixed", "empty_docs"):
        x, m = _batch(*CASES[case])
        jpool.compact_pooled_finish(
            jpool.compact_pooled_begin(jnp.asarray(x), jnp.asarray(m)))
        tpool.compact_pooled_finish(tpool.compact_pooled_begin(
            torch.from_numpy(x), torch.from_numpy(m)))
    got = tpool.compaction_transfer_stats(reset=True)
    assert got == jpool.compaction_transfer_stats(reset=True)
    assert got["batches"] == 2 and got["padded_bytes"] > 0
    assert tpool.compaction_transfer_stats() == {
        "padded_bytes": 0, "compact_bytes": 0, "batches": 0}


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_compact_share_at_most_one_over_factor(factor, fresh_stats):
    rng = np.random.default_rng(factor)
    x = rng.normal(size=(6, 32, 16)).astype(np.float32)
    m = np.ones((6, 32), bool)
    m[:, 28:] = False
    jp, jm = jpool.pool_doc_embeddings(jnp.asarray(x), jnp.asarray(m),
                                       factor, "ward")
    tp, tm = tpool.pool_doc_embeddings(torch.from_numpy(x),
                                       torch.from_numpy(m), factor, "ward")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jpool.compact_pooled_finish(jpool.compact_pooled_begin(jp, jm))
    got = tpool.compact_pooled_finish(tpool.compact_pooled_begin(tp, tm))
    assert [len(g) for g in got] == [len(w) for w in want]
    st = tpool.compaction_transfer_stats()
    assert st == jpool.compaction_transfer_stats()
    assert st["compact_bytes"] / st["padded_bytes"] <= 1 / factor + 1 / 64


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_pooled_unchanged(case):
    """``compact_pooled_flat``: the boolean gather's output bit for bit,
    rows, counts and their dtype."""
    x, m = _batch(*CASES[case])
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    flat, counts = tpool.compact_pooled_flat(xt, mt)
    assert torch.equal(flat, xt[mt]) and flat.shape == xt[mt].shape
    assert counts.dtype == torch.int64
    assert torch.equal(counts, mt.sum(dim=1))


# --------------------------------------------------------------- indexer
@pytest.fixture(scope="module")
def encoders():
    jcfg = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tcfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(0), jcfg)
    model = tcol.ColBERT(tcfg, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "compaction", n_docs=37, n_queries=4, doc_len_mean=30,
        doc_len_std=10, seed=3), vocab_size=1024)
    return params, jcfg, model, corpus.doc_token_batch(46)


def _serial(indexer, docs):
    """The loop before the pipeline: encode, pool and
    ``compact_pooled_flat`` each batch in turn."""
    rows, counts, raw = [], [], 0
    B = indexer.encode_batch
    for lo in range(0, len(docs), B):
        chunk = docs[lo:lo + B]
        n = len(chunk)
        chunk = np.pad(chunk, ((0, B - n), (0, 0)))
        v, emit = tcol.encode_docs(indexer.model, chunk)
        pooled, pmask = indexer.pooling.apply(v, emit)
        if not torch.is_tensor(pooled):
            pooled, pmask = torch.as_tensor(pooled), torch.as_tensor(pmask)
        flat, cnt = tpool.compact_pooled_flat(pooled[:n], pmask[:n])
        rows.append(flat)
        counts.append(cnt)
        raw += int(emit[:n].sum())
    return torch.cat(rows), torch.cat(counts).numpy(), raw


@pytest.mark.parametrize("encode_batch,factor", [(16, 2), (64, 2), (8, 3)])
def test_pipelined_loop_equals_serial_and_reference(encoders, encode_batch,
                                                   factor):
    """16 and 8: a ragged last batch (37 docs); 64: one batch."""
    params, jcfg, model, docs = encoders
    spec = rt.IndexSpec(backend="flat", doc_maxlen=48)
    indexer = rt.Indexer(model, index_spec=spec,
                         pooling_spec=rt.PoolingSpec("ward", factor),
                         encode_batch=encode_batch, device="cpu")
    times = {}
    flat, counts, raw = indexer.encode_and_pool_counted(docs, times=times)
    assert set(times) == {"encode", "pool"} and times["pool"] > 0
    s_flat, s_counts, s_raw = _serial(indexer, docs)
    assert torch.equal(flat, s_flat)
    np.testing.assert_array_equal(counts, s_counts)
    assert counts.dtype == np.int64 and raw == s_raw
    jindexer = JIndexer(params, jcfg,
                        index_spec=JIndexSpec(backend="flat", doc_maxlen=48),
                        pooling_spec=JPoolingSpec("ward", factor),
                        encode_batch=encode_batch)
    jdocs, jraw = jindexer.encode_and_pool_counted(docs)
    assert raw == jraw
    assert counts.tolist() == [len(d) for d in jdocs]
    np.testing.assert_allclose(flat.numpy(), np.concatenate(jdocs),
                               rtol=0, atol=ROWS_ATOL)


def test_indexer_moves_only_counts(encoders, fresh_stats):
    """The rows stay on the device: the loop adds each batch's padded
    bytes as the reference's does, and only the counts as moved."""
    params, jcfg, model, docs = encoders
    indexer = rt.Indexer(model, index_spec=rt.IndexSpec(backend="flat",
                                                        doc_maxlen=48),
                         pooling_spec=rt.PoolingSpec("ward", 2),
                         encode_batch=16, device="cpu")
    indexer.encode_and_pool_counted(docs)
    got = tpool.compaction_transfer_stats()
    JIndexer(params, jcfg, index_spec=JIndexSpec(backend="flat",
                                                 doc_maxlen=48),
             pooling_spec=JPoolingSpec("ward", 2),
             encode_batch=16).encode_and_pool_counted(docs)
    want = jpool.compaction_transfer_stats()
    per_doc = 48 * model.cfg.proj_dim * 4        # one doc's [N, d] f32
    assert got["batches"] == want["batches"] == 3
    # the reference compacts the padded last batch whole (48 docs), the
    # port its real docs (37)
    assert want["padded_bytes"] == 48 * per_doc
    assert got["padded_bytes"] == len(docs) * per_doc
    assert got["compact_bytes"] == 4 * len(docs)


def test_host_strategy_takes_the_synchronous_path(encoders):
    """A registered strategy returning numpy arrays: compacted at once,
    the same rows as the serial loop."""
    _, _, model, docs = encoders

    def host_halves(x, mask, factor):
        x, mask = np.asarray(x), np.asarray(mask).copy()
        mask[:, ::factor] = False
        return np.where(mask[..., None], x, 0.0).astype(np.float32), mask

    rt.register_pooling_strategy("compaction-host", host_halves,
                                 overwrite=True)
    indexer = rt.Indexer(model, index_spec=rt.IndexSpec(backend="flat",
                                                        doc_maxlen=48),
                         pooling_spec=rt.PoolingSpec("compaction-host", 2),
                         encode_batch=16, device="cpu")
    flat, counts, raw = indexer.encode_and_pool_counted(docs)
    s_flat, s_counts, s_raw = _serial(indexer, docs)
    assert torch.equal(flat, s_flat) and raw == s_raw
    np.testing.assert_array_equal(counts, s_counts)


def _digests(root):
    """{shard dir/payload name: sha256 of its .npy bytes}."""
    out = {}
    for e in read_manifest(root)["shards"]:
        sub = os.path.join(root, e["dir"])
        for name, p in read_manifest(sub)["payloads"].items():
            with open(os.path.join(sub, p["file"]), "rb") as fh:
                out[f"{e['dir']}/{name}"] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_build_streaming_shards_byte_equal(encoders, tmp_path):
    params, jcfg, model, docs = encoders
    spec = rt.IndexSpec(backend="flat", doc_maxlen=48)
    indexer = rt.Indexer(model, index_spec=spec,
                         pooling_spec=rt.PoolingSpec("ward", 2),
                         encode_batch=8, device="cpu")
    batches = [docs[:12], docs[12:12], docs[12:30], docs[30:]]
    runs = {}
    for pipeline in (True, False):
        out = str(tmp_path / f"p{int(pipeline)}")
        sharded, stats = indexer.build_streaming(
            iter(batches), shard_max_vectors=300, out_dir=out,
            pipeline=pipeline)
        runs[pipeline] = (stats, _digests(out), list(sharded.doc_base))
    (st1, d1, b1), (st0, d0, b0) = runs[True], runs[False]
    assert d1 == d0 and b1 == b0 and len(d1) > 0
    assert st1.n_shards == st0.n_shards > 1
    jidx = JIndexer(params, jcfg,
                    index_spec=JIndexSpec(backend="flat", doc_maxlen=48),
                    pooling_spec=JPoolingSpec("ward", 2), encode_batch=8)
    _, jst = jidx.build_streaming(iter(batches), shard_max_vectors=300)
    for f in ("n_docs", "n_vectors_raw", "n_vectors_stored", "n_shards",
              "peak_buffered_vectors", "max_batch_vectors"):
        assert getattr(st1, f) == getattr(jst, f), f
