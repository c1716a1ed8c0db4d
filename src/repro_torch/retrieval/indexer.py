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
import warnings
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.persist import artifact_bytes, serialized_nbytes
from repro_torch.core.pooling import CompactionTicket, compact_pooled_begin
from repro_torch.core.quantization import ResidualCodec
from repro_torch.core.spec import BACKENDS, IndexSpec, PoolingSpec
from repro_torch.device import DeviceLike, resolve_device, sync
from repro_torch.models.colbert import ColBERT, encode_docs
from repro_torch.trace import span


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
            v, emit = encode_docs(model, _upload(chunk, model.device))
            batches.append((v, emit, n_real))
        return cls(batches, n_docs=N, encode_batch=B)

    def nbytes(self) -> int:
        """Device bytes held by the cached encodes: every batch's vectors
        and emit mask."""
        return sum(v.numel() * v.element_size()
                   + emit.numel() * emit.element_size()
                   for v, emit, _ in self.batches)


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
    # seconds per build stage: encode and pool the device time between
    # CUDA events on the card (``_StageClock``; the host clock on the
    # CPU), index and save the host clock around synchronized work
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
    with span("build.views"):
        if index._plaid is not None:
            index._plaid.padded_packed()
            index._plaid.device_ivf()
        elif index._store is not None and index.n_docs:
            index._store.padded()


def _upload(tokens: np.ndarray, device: torch.device) -> torch.Tensor:
    """A token chunk on ``device`` without waiting for its queue: a copy
    from pageable memory to the card waits for the stream to drain, one
    queued from pinned memory does not."""
    t = torch.from_numpy(np.ascontiguousarray(tokens))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _finished(done, raw: torch.Tensor, tag):
    """A pipelined batch's (rows, counts, raw, tag), its compaction
    ticket finished on the device."""
    if isinstance(done, CompactionTicket):
        done = done.device_rows()
    return done[0], done[1], raw, tag


class _StageClock:
    """Seconds per build stage, added to ``times``, each stage inside the
    span ``build.<stage>`` (``repro_torch/trace.py``). ``stage``: on the
    card, CUDA events recorded around the stage's launches and read once,
    in ``close`` (the device's time between them; nothing in the loop
    waits); on the CPU, where the work is done when a call returns, the
    host clock. ``host_stage``: the host clock around work that ends
    with the call (the index stage ends in a ``sync``)."""

    def __init__(self, device: torch.device,
                 times: Optional[Dict[str, float]]):
        self.cuda = device.type == "cuda"
        self.times = {} if times is None else times
        self.times.setdefault("encode", 0.0)
        self.times.setdefault("pool", 0.0)
        self.marks = []

    @contextmanager
    def stage(self, name: str):
        if not self.cuda:
            with self.host_stage(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with span("build." + name):
            start.record()
            yield
            end.record()
        self.marks.append((name, start, end))

    @contextmanager
    def host_stage(self, name: str):
        with span("build." + name):
            t0 = time.perf_counter()
            yield
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)

    def close(self) -> None:
        for name, start, end in self.marks:
            end.synchronize()
            self.times[name] += start.elapsed_time(end) / 1e3
        self.marks.clear()


class Indexer:
    def __init__(self, model: ColBERT, index_spec: Optional[IndexSpec] = None,
                 pooling_spec: Optional[PoolingSpec] = None,
                 encode_batch: int = 64, device: DeviceLike = None, *,
                 pool_method: Optional[str] = None,
                 pool_factor: Optional[int] = None,
                 backend: Optional[str] = None, **index_kw):
        """The typed surface is ``index_spec`` / ``pooling_spec``. The
        reference's shorthand ``pool_method`` / ``pool_factor`` /
        ``backend`` builds the same specs (the rest from the model's
        config); a shorthand beside its spec raises ``TypeError``. Raw
        ``**index_kw`` construction knobs are deprecated in favour of
        ``index_spec=IndexSpec(...)``, as in the reference."""
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, indexer on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        if index_spec is not None and (backend is not None or index_kw):
            raise TypeError("pass either index_spec or loose "
                            "backend/**index_kw knobs, not both")
        if pooling_spec is not None and (pool_method is not None
                                         or pool_factor is not None):
            raise TypeError("pass either pooling_spec or loose "
                            "pool_method/pool_factor knobs, not both")
        if index_kw:
            warnings.warn(
                "Indexer(**index_kw) is deprecated; pass "
                "index_spec=repro_torch.IndexSpec(...) (see "
                "repro_torch.core.spec)", DeprecationWarning, stacklevel=2)
        self.index_spec = index_spec or IndexSpec.from_config(
            model.cfg, backend=backend, **index_kw)
        if self.index_spec.backend not in BACKENDS:
            raise ValueError(
                f"Indexer builds {BACKENDS} indexes; backend "
                f"{self.index_spec.backend!r} builds through "
                f"repro_torch.Retriever")
        self.pooling = pooling_spec or PoolingSpec(
            method=pool_method or model.cfg.pool_method,
            factor=max(int(pool_factor if pool_factor is not None
                           else model.cfg.pool_factor), 1))
        # the reference's attribute surface
        self.pool_method = self.pooling.method
        self.pool_factor = self.pooling.factor
        self.backend = self.index_spec.backend
        self.encode_batch = int(encode_batch)

    def _chunks(self, doc_tokens: np.ndarray):
        """(chunk [encode_batch, L] on the device, n_real_docs) per
        encode batch of ``doc_tokens``, the last chunk zero-padded."""
        N, B = doc_tokens.shape[0], self.encode_batch
        for lo in range(0, N, B):
            chunk = doc_tokens[lo:lo + B]
            n_real = chunk.shape[0]
            if n_real < B:
                chunk = np.pad(chunk, ((0, B - n_real), (0, 0)))
            yield _upload(chunk, self.device), n_real

    def _encoded_batches(self, token_batches, clock: "_StageClock"):
        """Yield (vectors [B, N, d], emit [B, N], n_real_docs, last) per
        encode batch of each [n_b, L] array in ``token_batches`` (empty
        ones skipped), ``last`` True on a token batch's last encode
        batch; or the batches of an ``EncodedDocs``."""
        if isinstance(token_batches, EncodedDocs):
            for v, emit, n_real in token_batches.batches:
                yield v, emit, n_real, True
            return
        for batch in token_batches:
            batch = np.asarray(batch)
            if batch.size == 0:
                continue
            chunks = list(self._chunks(batch))
            for i, (chunk, n_real) in enumerate(chunks):
                with clock.stage("encode"):
                    v, emit = encode_docs(self.model, chunk)
                yield v, emit, n_real, i == len(chunks) - 1

    def _pooled_batches(self, encoded, impl: str, clock: "_StageClock"):
        """Pool and compact each encoded batch, one batch behind: batch
        i+1 is encoded, pooled and its compaction queued
        (``compact_pooled_begin``) before batch i's ticket is finished, so
        the host's wait for batch i's counts overlaps the card's work on
        batch i+1, and nothing in the loop waits for the whole device.
        ``encoded`` yields (v, emit, n_real, tag); this yields (rows
        [M, d] on the device, counts [n_real] int32 on the host, the raw
        emitted-vector count as a device scalar, tag) in input order. A
        host strategy's output (a registered pooling function returning
        arrays) is compacted at once, as the reference does."""
        pending = None
        for v, emit, n_real, tag in encoded:
            with clock.stage("pool"):
                pooled, pmask = self.pooling.apply(v, emit, impl=impl)
                raw = emit[:n_real].sum()
                if torch.is_tensor(pooled):
                    done = compact_pooled_begin(pooled[:n_real],
                                                pmask[:n_real])
                else:       # a host strategy's arrays: compacted at once
                    pooled = torch.as_tensor(np.asarray(pooled),
                                             device=v.device)
                    pmask = torch.as_tensor(np.asarray(pmask, bool),
                                            device=v.device)
                    done = compact_pooled_begin(
                        pooled[:n_real], pmask[:n_real]).device_rows()
            if pending is not None:
                yield _finished(*pending)
            pending = (done, raw, tag)
        if pending is not None:
            yield _finished(*pending)

    def encode_and_pool_counted(self, doc_tokens, impl: str = "auto",
                                times: Optional[Dict[str, float]] = None
                                ) -> Tuple[torch.Tensor, np.ndarray, int]:
        """doc_tokens [N, L] (or an ``EncodedDocs``) -> (pooled rows
        [M, dim] doc-major, per-doc counts [N] int64, raw emitted-vector
        count), through the one-batch-behind loop of
        ``_pooled_batches``; ``times`` gains the encode and pool stages'
        seconds (``_StageClock``)."""
        clock = _StageClock(self.device, times)
        rows, counts, raw = [], [], []
        if not isinstance(doc_tokens, EncodedDocs):
            doc_tokens = [doc_tokens]
        for flat, cnt, raw_b, _ in self._pooled_batches(
                self._encoded_batches(doc_tokens, clock), impl, clock):
            rows.append(flat)
            counts.append(cnt)
            raw.append(raw_b)
        clock.close()
        if not rows:
            dim = self.cfg.proj_dim
            return (torch.zeros((0, dim), device=self.device),
                    np.zeros(0, np.int64), 0)
        return (torch.cat(rows).float(),
                np.concatenate(counts).astype(np.int64),
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
        clock = _StageClock(self.device, times)
        with clock.host_stage("index"):
            index = MultiVectorIndex(dim=self.cfg.proj_dim,
                                     backend=self.backend, device=self.device,
                                     **self.index_spec.params())
            if codec is not None:
                index.set_codec(codec)
            index.add_flat(flat, counts)
            _build_views(index)
            sync(self.device)
        if out_dir is not None:
            with clock.host_stage("save"):
                manifest = index.save(out_dir, extra_meta={
                    "pool": self.pooling.manifest_meta()})
                index_bytes = artifact_bytes(manifest)
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
        buffered = peak = max_batch = 0
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

        clock = _StageClock(self.device, times)
        rows: List[torch.Tensor] = []
        counts: List[np.ndarray] = []
        raw_parts: List[torch.Tensor] = []
        try:
            for flat, cnt, raw_b, last in self._pooled_batches(
                    self._encoded_batches(token_batches, clock), impl,
                    clock):
                rows.append(flat)
                counts.append(cnt)
                raw_parts.append(raw_b)
                if not last:
                    continue
                flat = torch.cat(rows).float()
                cnt = np.concatenate(counts)
                rows, counts = [], []
                got = int(cnt.sum())
                max_batch = max(max_batch, got)
                buffer.extend(torch.split(flat, cnt.tolist()))
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
        clock.close()
        raw = int(torch.stack(raw_parts).sum()) if raw_parts else 0

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
