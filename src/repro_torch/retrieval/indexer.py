"""Indexer: encode -> TOKEN POOL -> index, the paper's pipeline.

Counterpart of ``src/repro/retrieval/indexer.py``. ``Indexer.build``:

  1. encode documents in batches of ``encode_batch`` with the ColBERT
     encoder (the last batch zero-padded to full width),
  2. pool each batch (``PoolingSpec``; Ward through the ``ward_pool``
     kernel) and compact the pooled rows on the device,
  3. build the index (plaid, hnsw or flat) from the compacted rows,
  4. with ``out_dir``, write the artifact (``core/persist.py``) and a
     ``stats.json`` beside its manifest.

``Indexer.build_streaming`` is the same pipeline with a bounded buffer:
token batches are encoded and pooled one by one, and the pooled rows
are flushed into a new shard of a ``ShardedIndex`` whenever
``shard_max_vectors`` is reached (documents stay whole). With
``out_dir`` each shard is saved as it is flushed, dropped, and loaded
again memory-mapped. With ``pipeline=True`` one background thread
builds, saves and reloads the shards, in order, while the encoder runs
on the next batches; the shards, their ids and their artifact bytes are
the serial build's.

``EncodedDocs`` keeps a corpus encoded once (the same batches and
padding as ``build``), so several pooling configurations build from one
encoder pass.

Everything stays on the model's device; host work is the IVF
bookkeeping of the build and the artifact writes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.persist import artifact_bytes, serialized_nbytes
from repro_torch.core.pooling import compact_pooled
from repro_torch.core.quantization import ResidualCodec
from repro_torch.core.spec import BACKENDS, IndexSpec, PoolingSpec
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.models.colbert import ColBERT, encode_docs


class EncodedDocs:
    """A corpus encoded once, reusable across pooling configurations.

    Holds each encode batch's ``(vectors [B, N, d], emit [B, N],
    n_real_docs)`` on the device, with the batch boundaries and padding
    of ``Indexer.build``, so pooling and indexing from it equals
    re-encoding the tokens, without the encoder. ``Indexer.build``
    takes it in place of a token array; ``build_streaming`` refuses it."""

    def __init__(self, batches, n_docs: int, encode_batch: int):
        self.batches = batches
        self.n_docs = int(n_docs)
        self.encode_batch = int(encode_batch)

    @classmethod
    def encode(cls, model: ColBERT, doc_tokens: np.ndarray,
               encode_batch: int = 64) -> "EncodedDocs":
        """Run the document encoder over ``doc_tokens`` [N, L] in chunks
        of ``encode_batch`` (the last zero-padded to full width)."""
        doc_tokens = np.asarray(doc_tokens)
        N, B = doc_tokens.shape[0], int(encode_batch)
        batches = []
        for lo in range(0, N, B):
            chunk = doc_tokens[lo:lo + B]
            n_real = chunk.shape[0]
            if n_real < B:
                chunk = np.pad(chunk, ((0, B - n_real), (0, 0)))
            v, emit = encode_docs(model, chunk)
            batches.append((v, emit, n_real))
        return cls(batches, n_docs=N, encode_batch=B)


@dataclass
class IndexStats:
    n_docs: int
    n_vectors_raw: int
    n_vectors_stored: int
    index_bytes: int = 0     # serialized artifact size (core/persist.py)
    device_bytes: int = 0
    # streaming builds only
    n_shards: int = 1
    peak_buffered_vectors: int = 0   # pooled-buffer high-water mark
    max_batch_vectors: int = 0       # largest yield of one token batch
    pipelined: bool = False
    flush_wait_s: float = 0.0        # encoder stalled behind the flush
    flush_busy_s: float = 0.0        # wall seconds inside flush
    # wall seconds per build stage (host clock around synchronized work)
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def vector_reduction(self) -> float:
        if self.n_vectors_raw == 0:
            return 0.0
        return 1.0 - self.n_vectors_stored / self.n_vectors_raw

    def to_json(self) -> dict:
        return dict(dataclasses.asdict(self),
                    vector_reduction=self.vector_reduction)


def _write_stats(out_dir: str, stats: IndexStats) -> None:
    with open(os.path.join(out_dir, "stats.json"), "w") as fh:
        json.dump(stats.to_json(), fh, indent=2)


def _build_views(index: MultiVectorIndex) -> None:
    """Build the device views search reads, so that the first query does
    not."""
    if index._plaid is not None:
        index._plaid.padded_packed()
        index._plaid.device_ivf()
    elif index._store is not None and index.n_docs:
        index._store.padded()


class Indexer:
    def __init__(self, model: ColBERT, index_spec: Optional[IndexSpec] = None,
                 pooling_spec: Optional[PoolingSpec] = None,
                 encode_batch: int = 64, device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, indexer on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.index_spec = index_spec or IndexSpec.from_config(model.cfg)
        if self.index_spec.backend not in BACKENDS:
            raise ValueError(
                f"Indexer builds {BACKENDS} indexes; backend "
                f"{self.index_spec.backend!r} builds through "
                f"repro_torch.Retriever")
        self.pooling = pooling_spec or PoolingSpec(
            method=model.cfg.pool_method, factor=model.cfg.pool_factor)
        self.backend = self.index_spec.backend
        self.encode_batch = int(encode_batch)

    def _encoded_batches(self, doc_tokens, times: Dict[str, float]):
        """Yield (vectors [B, N, d], emit [B, N], n_real_docs) per encode
        batch, from the encoder or from an ``EncodedDocs``."""
        if isinstance(doc_tokens, EncodedDocs):
            yield from doc_tokens.batches
            return
        doc_tokens = np.asarray(doc_tokens)
        N, B = doc_tokens.shape[0], self.encode_batch
        for lo in range(0, N, B):
            chunk = doc_tokens[lo:lo + B]
            n_real = chunk.shape[0]
            if n_real < B:
                chunk = np.pad(chunk, ((0, B - n_real), (0, 0)))
            t0 = time.perf_counter()
            v, emit = encode_docs(self.model, chunk)
            sync(self.device)
            times["encode"] += time.perf_counter() - t0
            yield v, emit, n_real

    def encode_and_pool_counted(self, doc_tokens, impl: str = "auto",
                                times: Optional[Dict[str, float]] = None
                                ) -> Tuple[torch.Tensor, np.ndarray, int]:
        """doc_tokens [N, L] (or an ``EncodedDocs``) -> (pooled rows
        [M, dim] doc-major, per-doc counts [N], raw emitted-vector
        count)."""
        times = {} if times is None else times
        times.setdefault("encode", 0.0)
        times.setdefault("pool", 0.0)
        rows, counts, raw = [], [], []
        for v, emit, n_real in self._encoded_batches(doc_tokens, times):
            t0 = time.perf_counter()
            pooled, pmask = self.pooling.apply(v, emit, impl=impl)
            if not torch.is_tensor(pooled):    # a host strategy's output
                pooled = torch.as_tensor(np.asarray(pooled), device=v.device)
                pmask = torch.as_tensor(np.asarray(pmask, bool),
                                        device=v.device)
            flat, cnt = compact_pooled(pooled[:n_real], pmask[:n_real])
            sync(self.device)
            times["pool"] += time.perf_counter() - t0
            rows.append(flat)
            counts.append(cnt)
            raw.append(emit[:n_real].sum())
        if not rows:
            dim = self.cfg.proj_dim
            return (torch.zeros((0, dim), device=self.device),
                    np.zeros(0, np.int64), 0)
        return (torch.cat(rows).float(), torch.cat(counts).cpu().numpy(),
                int(torch.stack(raw).sum()))

    def encode_and_pool(self, doc_tokens) -> List[torch.Tensor]:
        """doc_tokens [N, L] -> per-doc pooled vectors ([n_i, dim] views
        on the device), the list form ``add`` and ``build_cascade``
        take."""
        flat, counts, _ = self.encode_and_pool_counted(doc_tokens)
        return list(torch.split(flat, counts.tolist()))

    def build(self, doc_tokens, codec: Optional[ResidualCodec] = None,
              impl: str = "auto", out_dir: Optional[str] = None
              ) -> Tuple[MultiVectorIndex, IndexStats]:
        """doc_tokens [N, L] raw ids (or an ``EncodedDocs``) ->
        (MultiVectorIndex, IndexStats). ``codec`` presets the plaid
        residual codec (``set_codec``) instead of training one on the
        pooled vectors. ``out_dir`` writes the artifact (with the
        ``pool`` entry) and ``stats.json``; ``index_bytes`` is always the
        serialized size."""
        times: Dict[str, float] = {}
        flat, counts, raw = self.encode_and_pool_counted(doc_tokens, impl,
                                                         times)
        t0 = time.perf_counter()
        index = MultiVectorIndex(dim=self.cfg.proj_dim, backend=self.backend,
                                 device=self.device,
                                 **self.index_spec.params())
        if codec is not None:
            index.set_codec(codec)
        index.add_flat(flat, counts)
        _build_views(index)
        sync(self.device)
        times["index"] = time.perf_counter() - t0
        if out_dir is not None:
            t0 = time.perf_counter()
            manifest = index.save(out_dir, extra_meta={
                "pool": self.pooling.manifest_meta()})
            index_bytes = artifact_bytes(manifest)
            times["save"] = time.perf_counter() - t0
        else:
            index_bytes = serialized_nbytes(index)
        stats = IndexStats(n_docs=index.n_docs, n_vectors_raw=raw,
                           n_vectors_stored=index.n_vectors(),
                           index_bytes=index_bytes,
                           device_bytes=index.device_bytes(),
                           stage_seconds=times)
        if out_dir is not None:
            _write_stats(out_dir, stats)
        return index, stats

    # ------------------------------------------------------------ streaming
    def build_streaming(self, token_batches: Iterable[np.ndarray],
                        shard_max_vectors: int,
                        out_dir: Optional[str] = None,
                        probe_threads: int = 0, pipeline: bool = True,
                        impl: str = "auto"):
        """Bounded-buffer build: token batches -> capped shards.

        ``token_batches``: an iterable of [n_b, L] token arrays, or one
        [N, L] array, split into batches of ``encode_batch``. A shard is
        flushed once the pooled buffer holds ``shard_max_vectors``
        vectors, so the buffer peaks at ``shard_max_vectors`` plus one
        batch's yield (``IndexStats.peak_buffered_vectors``).
        ``probe_threads`` sizes the built index's probe pool (0 = auto;
        a pinned value is recorded in the root manifest). With
        ``out_dir`` each shard is saved to ``out_dir/shard_XXXXX`` as it
        is flushed, dropped, and loaded again memory-mapped, then the
        root manifest and ``stats.json`` are written. ``pipeline=True``
        flushes on one background thread, fed through a queue of depth
        1, strictly in order; a flush failure is raised here.

        Returns (ShardedIndex, IndexStats), ids global and in stream
        order."""
        from repro_torch.core.persist import _shard_dirname, finalize_sharded
        from repro_torch.core.sharded import ShardedIndex

        if int(shard_max_vectors) <= 0:
            raise ValueError(f"shard_max_vectors must be > 0, got "
                             f"{shard_max_vectors!r}")
        if isinstance(token_batches, EncodedDocs):
            raise TypeError(
                "build_streaming takes raw token batches — the point of "
                "the streaming path is never materializing the corpus; "
                "EncodedDocs caches feed monolithic builds only")
        if isinstance(token_batches, np.ndarray):
            arr, B = token_batches, self.encode_batch
            token_batches = (arr[lo:lo + B] for lo in range(0, len(arr), B))
        sharded = ShardedIndex(dim=self.cfg.proj_dim, backend=self.backend,
                               shard_max_vectors=shard_max_vectors,
                               probe_threads=probe_threads,
                               device=self.device, **self.index_spec.params())
        times: Dict[str, float] = {}
        buffer: "deque[torch.Tensor]" = deque()
        buffered = raw = peak = max_batch = 0
        flush_wait_s = flush_busy_s = 0.0

        def flush(group: List[torch.Tensor]) -> None:
            nonlocal flush_busy_s
            t0 = time.perf_counter()
            shard = sharded._new_shard()
            shard.add_flat(torch.cat(group), [len(d) for d in group])
            if out_dir is not None:
                sub = os.path.join(out_dir,
                                   _shard_dirname(sharded.n_shards - 1))
                shard.save(sub)
                # drop the built shard before loading it again, so that
                # it is never on the card twice
                sharded.shards[-1] = shard = None
                shard = MultiVectorIndex.load(sub, mmap=True,
                                              device=self.device)
                sharded.shards[-1] = shard
            _build_views(shard)
            sync(self.device)
            flush_busy_s += time.perf_counter() - t0

        # one background flush lane: only it touches `sharded` during the
        # build, so shards are numbered in order
        handoff: "queue.Queue" = queue.Queue(maxsize=1)
        failures: List[BaseException] = []

        def flush_worker() -> None:
            while True:
                group = handoff.get()
                if group is None:
                    return
                try:
                    if not failures:
                        flush(group)
                except BaseException as exc:     # raised by submit / join
                    failures.append(exc)

        worker = None
        if pipeline:
            worker = threading.Thread(target=flush_worker,
                                      name="indexer-flush", daemon=True)
            worker.start()

        def submit(group: List[torch.Tensor]) -> None:
            nonlocal flush_wait_s
            if failures:
                raise failures[0]
            if worker is None:
                flush(group)
                return
            t0 = time.perf_counter()
            handoff.put(group)          # blocks only behind a backlog
            flush_wait_s += time.perf_counter() - t0

        try:
            for batch in token_batches:
                batch = np.asarray(batch)
                if batch.size == 0:
                    continue
                flat, counts, raw_b = self.encode_and_pool_counted(
                    batch, impl, times)
                raw += raw_b
                got = int(counts.sum())
                max_batch = max(max_batch, got)
                buffer.extend(torch.split(flat, counts.tolist()))
                buffered += got
                peak = max(peak, buffered)
                while buffered >= shard_max_vectors:
                    # one shard's worth off the head; the first doc always
                    # goes in and no doc is split
                    group: List[torch.Tensor] = []
                    used = 0
                    while buffer:
                        nxt = used + len(buffer[0])
                        if group and nxt > shard_max_vectors:
                            break
                        group.append(buffer.popleft())
                        used = nxt
                    submit(group)
                    buffered -= used
            if buffer:
                submit(list(buffer))
                buffer.clear()
        finally:
            if worker is not None:
                handoff.put(None)
                worker.join()
        if failures:
            raise failures[0]

        if out_dir is not None:
            manifest = finalize_sharded(sharded, out_dir, extra_meta={
                "pool": self.pooling.manifest_meta()})
            index_bytes = artifact_bytes(manifest)
        else:
            index_bytes = sum(serialized_nbytes(s) for s in sharded.shards)
        stats = IndexStats(
            n_docs=sharded.n_docs, n_vectors_raw=raw,
            n_vectors_stored=sharded.n_vectors(), index_bytes=index_bytes,
            device_bytes=sharded.device_bytes(), n_shards=sharded.n_shards,
            peak_buffered_vectors=peak, max_batch_vectors=max_batch,
            pipelined=bool(pipeline), flush_wait_s=flush_wait_s,
            flush_busy_s=flush_busy_s, stage_seconds=times)
        if out_dir is not None:
            _write_stats(out_dir, stats)
        return sharded, stats
