"""``repro_torch.Retriever``: the spec-driven facade over the pipeline.

Counterpart of ``src/repro/api.py``. One object, driven by one typed
spec (``core/spec.py``), from corpus to artifact to search::

    import repro_torch as rt

    model = rt.init_colbert(rt.CONFIG, seed=0)
    spec = rt.RetrieverSpec(pooling=rt.PoolingSpec("ward", 2),
                            shard=rt.ShardSpec(shard_max_vectors=524_288))
    r = rt.Retriever.build(model, doc_tokens, spec, out_dir="idx")
    scores, ids = r.search(query_tokens, k=10)

    r2 = rt.Retriever.load(model, "idx")        # the spec comes back
    assert r2.spec.index == spec.index

The port takes the ``ColBERT`` module where the reference takes
``(params, cfg)``, and a ``device`` (``cuda`` unless ``device="cpu"``).
Every backend of the registry builds through ``Retriever.build``: flat,
hnsw and plaid (monolithic, or streamed into shards when
``spec.shard.sharded``) and the pooled cascade. A new backend is one
``register_backend(name, kind, keys, builder)`` call; its builder takes
``(model, docs, spec, out_dir, encode_batch, device)`` and returns
``(index, IndexStats)``. ``evaluate`` and ``serve`` raise: eval and the
serving runtime are not ported yet (ROADMAP queue 1, items 4 and 6).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import persist
from repro_torch.core.spec import (BACKENDS, CASCADE_PARAM_KEYS,
                                   INDEX_PARAM_KEYS, IndexSpec,
                                   RetrieverSpec, ServeSpec, backend_info,
                                   register_backend,
                                   retriever_spec_from_manifest)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.colbert import (ColBERT, emit_mask_docs,
                                        prepare_doc_tokens)
from repro_torch.retrieval.indexer import (EncodedDocs, Indexer, IndexStats,
                                           _write_stats)
from repro_torch.retrieval.searcher import Searcher


def _as_token_array(docs):
    """A monolithic build takes one [N, L] token array (or an
    ``EncodedDocs``); an iterator of token batches is concatenated."""
    if isinstance(docs, (np.ndarray, EncodedDocs)):
        return docs
    return np.concatenate([np.asarray(b) for b in docs])


def _spec_extra_meta(spec: RetrieverSpec) -> dict:
    """The spec's manifest entries a facade save adds (from the helpers
    ``manifest_meta_for`` uses)."""
    extra = {"pool": spec.pooling.manifest_meta()}
    if spec.index.backend == "cascade":
        extra["params"] = spec.index.generic_params()
    return extra


def _raw_count(model: ColBERT, docs, device: torch.device) -> int:
    """Emitted (unpooled) doc vectors of a token array: the emit mask
    alone, no encoder pass."""
    if isinstance(docs, EncodedDocs):
        return int(sum(int(emit[:n].sum()) for _, emit, n in docs.batches))
    toks, attn = prepare_doc_tokens(torch.as_tensor(np.asarray(docs),
                                                    device=device),
                                    model.cfg.doc_maxlen)
    return int(emit_mask_docs(toks, attn, model.cfg.mask_punctuation).sum())


# ---------------------------------------------------------------------------
# Registry builders
# ---------------------------------------------------------------------------
def _build_multi_vector(model: ColBERT, docs, spec: RetrieverSpec,
                        out_dir: Optional[str], encode_batch: int,
                        device: torch.device):
    """flat | hnsw | plaid, monolithic or streamed into shards."""
    indexer = Indexer(model, index_spec=spec.index,
                      pooling_spec=spec.pooling, encode_batch=encode_batch,
                      device=device)
    if spec.shard.sharded:
        return indexer.build_streaming(
            docs, shard_max_vectors=int(spec.shard.shard_max_vectors),
            out_dir=out_dir, probe_threads=int(spec.shard.probe_threads))
    return indexer.build(_as_token_array(docs), out_dir=out_dir)


def _build_cascade(model: ColBERT, docs, spec: RetrieverSpec,
                   out_dir: Optional[str], encode_batch: int,
                   device: torch.device):
    """Encode once a pool level, store both levels (``build_cascade``)."""
    from repro_torch.retrieval.cascade import build_cascade
    docs = _as_token_array(docs)
    ix = spec.index
    index = build_cascade(model, docs, coarse_factor=ix.coarse_factor,
                          fine_factor=ix.fine_factor,
                          candidates=ix.candidates,
                          pool_method=spec.pooling.method,
                          encode_batch=encode_batch, device=device,
                          doc_maxlen=ix.doc_maxlen)
    if out_dir is not None:
        manifest = index.save(out_dir, extra_meta=_spec_extra_meta(spec))
        index_bytes = persist.artifact_bytes(manifest)
    else:
        index_bytes = persist.serialized_nbytes(index)
    stats = IndexStats(n_docs=index.n_docs,
                       n_vectors_raw=_raw_count(model, docs, device),
                       n_vectors_stored=index.n_vectors(),
                       index_bytes=index_bytes,
                       device_bytes=index.device_bytes())
    if out_dir is not None:
        _write_stats(out_dir, stats)
    return index, stats


# the stock backends with their builders (spec.py registered the names,
# kinds and keys without importing any build code)
for _b in BACKENDS:
    register_backend(_b, "multi_vector_index", INDEX_PARAM_KEYS,
                     builder=_build_multi_vector, overwrite=True)
register_backend("cascade", "cascade_index", CASCADE_PARAM_KEYS,
                 builder=_build_cascade, overwrite=True)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
class Retriever:
    """From corpus to search: ``build`` (encode, pool, index, and with
    ``out_dir`` save) from a ``RetrieverSpec``, or ``load`` an artifact
    with its spec read back from the manifest; then ``search`` /
    ``search_batch`` / ``rankings``, ``add`` / ``delete``, ``save`` and
    ``stats``."""

    def __init__(self, model: ColBERT, index, spec=None,
                 stats: Optional[IndexStats] = None,
                 encode_batch: int = 64):
        self.model = model
        self.cfg = model.cfg
        self.spec = RetrieverSpec.coerce(spec, model.cfg)
        self.encode_batch = int(encode_batch)
        self.searcher = Searcher(model, index, encode_batch=encode_batch)
        self._stats = stats

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def build(cls, model: ColBERT, docs, spec=None,
              out_dir: Optional[str] = None, encode_batch: int = 64,
              device: DeviceLike = None) -> "Retriever":
        """Encode ``docs`` (one [N, L] token array, an ``EncodedDocs``, or
        an iterator of token batches when ``spec.shard`` streams) in
        batches of ``encode_batch``, pool them per ``spec.pooling``,
        build ``spec.index.backend``'s index on ``device`` and, with
        ``out_dir``, write the artifact and ``stats.json``. ``spec``: a
        ``RetrieverSpec``, a bare ``IndexSpec`` / ``PoolingSpec`` /
        ``ShardSpec`` (the rest from the model's config), a dict, or
        None."""
        device = resolve_device(device)
        spec = RetrieverSpec.coerce(spec, model.cfg)
        info = backend_info(spec.index.backend)
        if info.builder is None:
            raise ValueError(f"backend {spec.index.backend!r} has no "
                             f"registered builder")
        index, stats = info.builder(model, docs, spec, out_dir,
                                    int(encode_batch), device)
        return cls(model, index, spec, stats=stats,
                   encode_batch=encode_batch)

    @classmethod
    def load(cls, model: ColBERT, path: str, mmap: bool = True,
             serve: Optional[ServeSpec] = None, encode_batch: int = 64,
             device: DeviceLike = None) -> "Retriever":
        """Serve the artifact at ``path`` (monolithic, sharded or
        cascade, written by either package) on ``device``: no encode, no
        build. The build spec comes back from the manifest (a manifest
        that carries none raises ``IndexFormatError``); ``serve`` is
        runtime-only."""
        device = resolve_device(device)
        manifest = persist.read_manifest(path)
        try:
            spec = retriever_spec_from_manifest(manifest, serve=serve)
        except ValueError as e:
            raise persist.IndexFormatError(str(e))
        index = persist.load_artifact(path, mmap=mmap, device=device)
        return cls(model, index, spec, stats=cls._load_stats(path),
                   encode_batch=encode_batch)

    @staticmethod
    def _load_stats(path: str) -> Optional[IndexStats]:
        sp = os.path.join(path, "stats.json")
        if not os.path.isfile(sp):
            return None
        try:
            with open(sp) as fh:
                d = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None
        known = {f.name for f in dataclasses.fields(IndexStats)}
        return IndexStats(**{k: v for k, v in d.items() if k in known})

    def save(self, out_dir: str) -> dict:
        """Write the current index as an artifact (a re-save bumps the
        manifest generation); returns the manifest."""
        manifest = self.index.save(out_dir,
                                   extra_meta=_spec_extra_meta(self.spec))
        if self._stats is not None:
            _write_stats(out_dir, self._stats)
        return manifest

    # ---------------------------------------------------------------- query
    @property
    def index(self):
        return self.searcher.index

    def search(self, query_tokens: np.ndarray, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """[Nq, L] raw token ids -> (scores [Nq, k], doc ids [Nq, k])."""
        return self.searcher.search(query_tokens, k=k)

    search_batch = search

    def rankings(self, query_tokens: np.ndarray, k: int = 10
                 ) -> List[List[int]]:
        return self.searcher.rankings(query_tokens, k=k)

    def warmup(self, batch_sizes: Union[int, Iterable[int]],
               k: int = 10) -> None:
        self.searcher.warmup(batch_sizes, k=k)

    def evaluate(self, dataset, metrics=("ndcg@10",), k: int = 10):
        raise NotImplementedError(
            "Retriever.evaluate: the eval subsystem is not ported yet "
            "(ROADMAP queue 1, item 4)")

    def serve(self, spec: Optional[ServeSpec] = None, index_dir=None,
              index_generation=None):
        raise NotImplementedError(
            "Retriever.serve: the serving runtime is not ported yet "
            "(ROADMAP queue 1, item 6)")

    # ----------------------------------------------------------------- CRUD
    def _encode_pool(self, doc_tokens, factor: int) -> List[torch.Tensor]:
        ix = self.spec.index
        enc_spec = (ix if ix.backend != "cascade"
                    else IndexSpec.from_config(self.cfg, backend="flat",
                                               doc_maxlen=ix.doc_maxlen))
        return Indexer(self.model, index_spec=enc_spec,
                       pooling_spec=self.spec.pooling.replace(
                           factor=max(int(factor), 1)),
                       encode_batch=self.encode_batch,
                       device=self.model.device).encode_and_pool(doc_tokens)

    def add(self, doc_tokens) -> np.ndarray:
        """Encode, pool and append new documents; returns their ids (a
        cascade pools each at both levels)."""
        toks = _as_token_array(doc_tokens)
        ix = self.spec.index
        self._stats = None              # stats are stale after an add
        if ix.backend == "cascade":
            return self.index.add(self._encode_pool(toks, ix.coarse_factor),
                                  self._encode_pool(toks, ix.fine_factor))
        return self.index.add(self._encode_pool(toks,
                                                self.spec.pooling.factor))

    def delete(self, doc_ids) -> None:
        fn = getattr(self.index, "delete", None)
        if fn is None:
            raise NotImplementedError(
                f"{type(self.index).__name__} does not support delete")
        self._stats = None
        fn(doc_ids)

    # ---------------------------------------------------------------- stats
    @property
    def stats(self) -> IndexStats:
        """The build's stats (or the artifact's ``stats.json``); after a
        bare load or a mutation, made from the live index (raw count
        0)."""
        if self._stats is None:
            index = self.index
            if hasattr(index, "shards"):
                nbytes = sum(persist.serialized_nbytes(s)
                             for s in index.shards)
            else:
                nbytes = persist.serialized_nbytes(index)
            self._stats = IndexStats(
                n_docs=int(index.n_docs), n_vectors_raw=0,
                n_vectors_stored=int(index.n_vectors()),
                index_bytes=int(nbytes),
                n_shards=int(getattr(index, "n_shards", 1)))
        return self._stats
