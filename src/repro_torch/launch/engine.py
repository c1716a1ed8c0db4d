"""Serving runtime: dynamic microbatching over the two-stage retrieval
engine, with shape-bucketed warmup and zero-downtime index hot swap
(counterpart of ``src/repro/launch/engine.py``).

  * ``ServingEngine.submit`` is thread-safe and non-blocking: requests
    (1..n queries each) land on a queue and return a ``SearchFuture``.
  * A deadline-based dynamic batcher coalesces in-flight requests into
    microbatches, flushing when ``max_batch`` queries are ready or the
    OLDEST waiting request has aged ``max_wait_ms`` (per-flush reasons
    are counted: full / deadline / drain / k_switch).
  * Every coalesced batch pads up to the nearest SHAPE BUCKET
    {1, 2, 4, ..., max_batch} by repeating its last encoded row
    (``torch.cat`` on the device); each bucket is warmed at ``start()``,
    which also builds every kernel library and lazy device view the
    served index needs, so ``CompileCounter`` reads 0 afterwards.
  * The two stages overlap: the batcher thread encodes batch N+1 while
    a search lane reranks batch N. The encoded rows stay on the card
    between the stages; the results come to the host once a batch.
    Every thread issues its work to the legacy default stream, in
    launch order.
  * With ``n_replicas > 1`` the engine wraps the served index in
    replica groups (``core/replicated.py``) and runs one search lane per
    group; each staged microbatch routes whole to a lane.
  * The index is held behind a refcounted, double-buffered
    ``IndexHandle``. A watcher thread polls the artifact directory's
    ``generation`` (``core/persist.py``); a new generation is loaded
    onto the card and pre-warmed in the background, then swapped in
    atomically. In-flight batches finish on the old handle, which
    retires once its last reader drains; an index the engine loaded is
    then closed and dropped, so its device memory is freed.

Parity contract: for every request, the engine's (scores, ids) equal a
direct ``searcher.search(request_tokens, k)`` — ids tie-aware, scores
within 1e-4 — through coalescing, padding to a bucket, and a hot swap
to an equivalent index. The searcher encodes every chunk at one width
(its ``encode_batch``), so a row of a coalesced batch is encoded as it
is alone (at the width the reference uses, the next power of two, the
card's bf16 GEMMs would move it by ~3e-3), and stage 2 reads only its
own row: the results are bitwise equal on the card and on the CPU.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------
def shape_buckets(max_batch: int) -> List[int]:
    """Powers of two up to ``max_batch`` (plus ``max_batch`` itself when
    it is not a power of two): the microbatch shapes warmed at start."""
    assert max_batch >= 1, max_batch
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return out


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest warm bucket that fits ``n`` queries."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds max bucket {buckets[-1]}")


# ---------------------------------------------------------------------------
# Kernel-library probe (regression guard for the warmup)
# ---------------------------------------------------------------------------
class CompileCounter:
    """``with CompileCounter() as c: ...; c.count`` — kernel libraries
    compiled or opened by ``kernels/build.py`` inside the block. Eager
    PyTorch compiles nothing per shape; what a first call can still pay
    mid-stream is a kernel library's build or load, which the engine's
    warmup takes up front, so a started engine reads 0."""

    def __enter__(self) -> "CompileCounter":
        from repro_torch.kernels.build import library_events
        self._start = library_events()
        return self

    def __exit__(self, *exc) -> None:
        self.count = self.so_far

    @property
    def so_far(self) -> int:
        from repro_torch.kernels.build import library_events
        return library_events() - self._start


# ---------------------------------------------------------------------------
# Futures
# ---------------------------------------------------------------------------
class SearchFuture:
    """Result slot for one submitted request (1..n queries).

    A request may span several microbatches (the batcher slices big
    requests at bucket boundaries); rows fill in as their batches
    complete and the future resolves when the last row lands.
    """

    def __init__(self, n_queries: int, k: int, submit_t: float):
        self.n_queries = n_queries
        self.k = k
        self.submit_t = submit_t
        self.done_t: Optional[float] = None
        self._scores = np.full((n_queries, k), -np.inf, np.float32)
        self._ids = np.full((n_queries, k), -1, np.int64)
        self._remaining = n_queries
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    # engine-side
    def _fill(self, lo: int, scores: np.ndarray, ids: np.ndarray) -> None:
        with self._lock:
            n = len(scores)
            self._scores[lo:lo + n] = scores
            self._ids[lo:lo + n] = ids
            self._remaining -= n
            if self._remaining == 0:
                self.done_t = time.perf_counter()
                self._event.set()

    def _fail(self, err: BaseException) -> None:
        with self._lock:
            self._error = err
            self.done_t = time.perf_counter()
            self._event.set()

    # caller-side
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        if not self._event.wait(timeout):
            raise TimeoutError("search request not served in time")
        if self._error is not None:
            raise self._error
        return self._scores, self._ids

    @property
    def latency_s(self) -> float:
        assert self.done_t is not None, "not resolved yet"
        return self.done_t - self.submit_t


class _Slice:
    """Rows [lo, lo+n) of ``future`` riding in the current microbatch."""

    __slots__ = ("future", "lo", "n", "enqueue_t")

    def __init__(self, future: SearchFuture, lo: int, n: int,
                 enqueue_t: float):
        self.future = future
        self.lo = lo
        self.n = n
        self.enqueue_t = enqueue_t


# ---------------------------------------------------------------------------
# Double-buffered index handle (hot swap)
# ---------------------------------------------------------------------------
class IndexHandle:
    """Refcounted index reference: the unit the engine double-buffers.

    Readers ``acquire()`` before a batch and ``release()`` after; a
    swap ``retire()``s the old handle, which fires ``on_retire`` only
    once its reader count drains to zero — so an in-flight batch always
    finishes on the index it started with, and the old generation's
    resources are let go exactly when the last reader leaves.
    """

    def __init__(self, index, generation: int = 0,
                 on_retire: Optional[Callable[["IndexHandle"], None]] = None,
                 owned: bool = False):
        self.index = index
        self.generation = generation
        # owned=True means the ENGINE materialized this index (loaded it
        # from the watched directory) and may release its resources at
        # retirement; caller-provided indexes are never closed.
        self.owned = owned
        self._on_retire = on_retire
        self._readers = 0
        self._retired = False
        self._cond = threading.Condition()

    def acquire(self):
        with self._cond:
            self._readers += 1
            return self.index

    def release(self) -> None:
        fire = False
        with self._cond:
            self._readers -= 1
            assert self._readers >= 0
            if self._retired and self._readers == 0:
                fire = True
                self._cond.notify_all()
        if fire and self._on_retire is not None:
            self._on_retire(self)

    def retire(self) -> None:
        fire = False
        with self._cond:
            self._retired = True
            if self._readers == 0:
                fire = True
                self._cond.notify_all()
        if fire and self._on_retire is not None:
            self._on_retire(self)

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(
                lambda: self._retired and self._readers == 0, timeout)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------
class EngineStats:
    """Counters + samples the batcher/search threads append under a lock;
    ``snapshot()`` aggregates them for reports (BENCH_serve.json).

    Sample series are bounded sliding windows (`maxlen`), so a
    long-running engine's stats stay O(window), not O(uptime); the
    scalar counters cover the full lifetime."""

    WINDOW = 65536                          # most recent samples kept

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.served = 0
        self.failed = 0
        self.batches = 0
        self.flush_reasons = {"full": 0, "deadline": 0, "drain": 0,
                              "k_switch": 0}
        self.batch_sizes: deque = deque(maxlen=self.WINDOW)
        self.bucket_sizes: deque = deque(maxlen=self.WINDOW)
        self.queue_wait_s: deque = deque(maxlen=self.WINDOW)
        self.swaps = 0
        self.generations_seen: deque = deque(maxlen=self.WINDOW)
        self.replica_batches: dict = {}     # lane id -> batches served

    def record_batch(self, n_real: int, bucket: int, reason: str,
                     waits: List[float], generation: int,
                     replica: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.flush_reasons[reason] += 1
            self.batch_sizes.append(n_real)
            self.bucket_sizes.append(bucket)
            self.queue_wait_s.extend(waits)
            self.served += n_real
            self.generations_seen.append(generation)
            self.replica_batches[replica] = (
                self.replica_batches.get(replica, 0) + 1)

    def record_failed(self, n: int) -> None:
        with self._lock:
            self.failed += n

    def record_swap(self) -> None:
        with self._lock:
            self.swaps += 1

    def snapshot(self) -> dict:
        with self._lock:
            waits = np.asarray(self.queue_wait_s, np.float64)
            return {
                "submitted": self.submitted,
                "served": self.served,
                "failed": self.failed,
                "batches": self.batches,
                "flush_reasons": dict(self.flush_reasons),
                "mean_batch_size": (float(np.mean(self.batch_sizes))
                                    if self.batch_sizes else 0.0),
                "mean_bucket_size": (float(np.mean(self.bucket_sizes))
                                     if self.bucket_sizes else 0.0),
                "queue_wait_p50_ms": (float(np.percentile(waits, 50) * 1e3)
                                      if waits.size else 0.0),
                "queue_wait_p99_ms": (float(np.percentile(waits, 99) * 1e3)
                                      if waits.size else 0.0),
                "swaps": self.swaps,
                "generations_seen": list(self.generations_seen),
                "replica_batches": dict(self.replica_batches),
            }


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class ServingEngine:
    """Dynamic-batching, hot-swapping serving runtime over a Searcher.

    ``searcher`` provides the two stateless stages (``encode_queries``
    + an index with ``search_batch``); the engine owns threading,
    batching, shape management, and index lifecycle. The active index
    starts as ``searcher.index`` (or the artifact at ``index_dir``) and
    is thereafter owned by the engine's handle — hot swaps replace it
    without the searcher noticing.

    ``device`` is where the engine serves (``cuda`` unless given); the
    searcher's model must live there. Use as a context manager::

        with ServingEngine(searcher, max_batch=32, max_wait_ms=2.0) as eng:
            fut = eng.submit(query_tokens)        # non-blocking
            scores, ids = fut.result()
    """

    def __init__(self, searcher, max_batch: int = 32,
                 max_wait_ms: float = 2.0, k: int = 10,
                 index_dir: Optional[str] = None,
                 poll_interval_s: float = 0.2,
                 warmup_on_start: bool = True,
                 pipeline_depth: Optional[int] = None,
                 index_generation: Optional[int] = None,
                 n_replicas: int = 1, device: DeviceLike = None):
        self.device = resolve_device(device)
        model_dev = getattr(getattr(searcher, "model", None), "device",
                            self.device)
        if torch.device(model_dev).type != self.device.type:
            raise ValueError(f"searcher's model is on {model_dev}, engine "
                             f"on {self.device}")
        self.searcher = searcher
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) * 1e-3
        self.default_k = int(k)
        self.buckets = shape_buckets(self.max_batch)
        self.index_dir = index_dir
        self.poll_interval_s = float(poll_interval_s)
        self.warmup_on_start = warmup_on_start
        self.n_replicas = int(n_replicas)
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")

        # Gen-0 index. A caller who already loaded/built the artifact
        # passes ``index_generation`` (read when it materialized the
        # index) and ``searcher.index`` serves directly — no duplicate
        # copy. Otherwise, when watching a directory, read the
        # generation BEFORE loading, then serve the loaded copy: a
        # publish racing either window leaves the label stale-LOW, so
        # the watcher performs one redundant swap instead of silently
        # serving an old index under a new generation number forever.
        index = searcher.index
        gen = 0
        owned = False
        if index_generation is not None:
            gen = int(index_generation)
        elif index_dir is not None:
            from repro_torch.core.persist import (IndexFormatError,
                                                  artifact_generation,
                                                  load_artifact)
            gen = artifact_generation(index_dir)
            if gen > 0:
                try:
                    index = load_artifact(index_dir, mmap=True,
                                          device=self.device)
                    owned = True
                except IndexFormatError:    # mid-publish: watcher retries
                    gen = 0
        index, owned = self._place(index, owned)
        self._handle = IndexHandle(index, generation=gen,
                                   on_retire=self._on_handle_retired,
                                   owned=owned)
        self._handle_lock = threading.Lock()

        self.stats = EngineStats()
        self._queue: deque = deque()        # of _Slice
        self._queue_cond = threading.Condition()
        self._staged: deque = deque()       # encoded batches, bounded
        self._staged_cond = threading.Condition()
        # pipeline depth: how many encoded batches may wait for the
        # search stage. 2 overlaps encode of batch N with rerank of
        # batch N-1 when the host has cores for both stages; below 4
        # cores the default degrades to depth 1, which runs BOTH stages
        # inline on the batcher thread (no staged handoff).
        if pipeline_depth is None:
            pipeline_depth = 2 if (os.cpu_count() or 1) >= 4 else 1
        self._staged_cap = max(int(pipeline_depth), 1)
        if self.n_replicas > 1:
            # the staged queue feeds every replica lane: it must hold at
            # least one batch per lane or lanes starve behind admission
            self._staged_cap = max(self._staged_cap, self.n_replicas)
        self._inline = self._staged_cap == 1
        self._stop = False
        self._batcher_done = False
        self._abandon = False
        self._pending = 0       # batches popped but not yet resolved
        self._threads: List[threading.Thread] = []
        self._started = False

    @classmethod
    def from_spec(cls, searcher, spec=None, **kw) -> "ServingEngine":
        """Build an engine from a typed ``ServeSpec`` (core/spec.py) —
        the one config surface ``Retriever.serve`` and the CLI share.
        Extra ``**kw`` (``index_dir``, ``index_generation``, ``device``)
        pass through to the constructor."""
        from repro_torch.core.spec import ServeSpec
        spec = spec if spec is not None else ServeSpec()
        return cls(searcher, max_batch=spec.max_batch,
                   max_wait_ms=spec.max_wait_ms, k=spec.k,
                   poll_interval_s=spec.poll_interval_s,
                   warmup_on_start=spec.warmup_on_start,
                   pipeline_depth=spec.pipeline_depth,
                   n_replicas=getattr(spec, "n_replicas", 1), **kw)

    # ----------------------------------------------------------- placement
    def _place(self, index, owned: bool):
        """Wrap the served index in replica groups (core/replicated.py)
        when the engine routes across ``n_replicas`` lanes. Returns
        (index, owned): single-lane engines serve the index untouched;
        multi-lane engines serve a ``ReplicatedIndex`` whose wrapper the
        engine always owns (the inner index is only closed when the
        ORIGINAL was engine-loaded)."""
        if self.n_replicas == 1:
            return index, owned
        from repro_torch.core.replicated import ReplicatedIndex
        if isinstance(index, ReplicatedIndex):
            return index, owned
        placed = ReplicatedIndex.replicate(index, self.n_replicas,
                                           own_inner=owned)
        return placed, True

    # ------------------------------------------------------------ lifecycle
    @property
    def generation(self) -> int:
        return self._handle.generation

    def start(self) -> "ServingEngine":
        assert not self._started, "engine already started"
        if self.warmup_on_start:
            self.warmup()
            # the served copy's lazy device views and every kernel
            # library its search launches, before traffic
            self._prewarm_index(self._handle.index)
        self._stop = False
        self._batcher_done = False
        self._threads = [
            threading.Thread(target=self._batcher_loop,
                             name="engine-batcher", daemon=True),
        ]
        if not self._inline:
            # one search lane per replica: lane r serves its batches on
            # replica group r (search_batch_on), so groups placed on
            # different device rows rerank concurrently
            for r in range(self.n_replicas):
                self._threads.append(
                    threading.Thread(target=self._search_loop, args=(r,),
                                     name=f"engine-search-{r}",
                                     daemon=True))
        if self.index_dir is not None:
            self._threads.append(
                threading.Thread(target=self._watch_loop,
                                 name="engine-watcher", daemon=True))
        for t in self._threads:
            t.start()
        self._started = True
        return self

    def warmup(self) -> None:
        """Run every shape bucket's encoder width once (and the index's
        ``warm_shapes``, a no-op in eager PyTorch)."""
        self.searcher.warmup(self.buckets, k=self.default_k)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the engine (terminal: a watcher-loaded index's resources
        are released). ``drain=True`` serves everything already
        submitted first; ``drain=False`` abandons the backlog — pending
        requests are failed, only the in-flight batch completes."""
        if not self._started:
            return
        if drain:
            # _pending covers a batch from pop until its futures
            # resolve — without it, a batch mid-encode is invisible to
            # both the queue and staged checks and would be swept as
            # failed despite drain=True
            with self._queue_cond:
                self._queue_cond.wait_for(
                    lambda: not self._queue and self._pending == 0,
                    timeout=timeout)
        else:
            self._abandon = True        # batcher exits without draining
        self._stop = True
        with self._queue_cond:
            self._queue_cond.notify_all()
        with self._staged_cond:
            self._staged_cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        err = RuntimeError("engine stopped before request was served")
        swept = list(self._queue) + [sl for staged in self._staged
                                     for sl in staged[3]]
        for sl in swept:
            sl.future._fail(err)
        if swept:                       # dropped rows count as failures
            self.stats.record_failed(sum(sl.n for sl in swept))
        self._queue.clear()
        self._staged.clear()
        self._pending = 0               # threads joined: nothing in flight
        self._started = False
        if self._handle.owned:          # release watcher-loaded resources
            self._handle.retire()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- submit
    def submit(self, query_tokens: np.ndarray,
               k: Optional[int] = None) -> SearchFuture:
        """Enqueue 1..n queries ([L] or [n, L] token ids); returns a
        ``SearchFuture``. Thread-safe, non-blocking."""
        assert self._started, "engine not started"
        q = np.asarray(query_tokens)
        if q.ndim == 1:                     # [L] -> [1, L]
            q = q[None]
        kk = self.default_k if k is None else int(k)
        now = time.perf_counter()
        fut = SearchFuture(len(q), kk, submit_t=now)
        fut._tokens = q                     # carried to the batcher
        with self._queue_cond:
            self.stats.submitted += len(q)
            self._queue.append(_Slice(fut, 0, len(q), now))
            self._queue_cond.notify_all()
        return fut

    def search(self, query_tokens: np.ndarray, k: Optional[int] = None,
               timeout: Optional[float] = 60.0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience: submit + wait."""
        return self.submit(query_tokens, k=k).result(timeout=timeout)

    # ---------------------------------------------------------- hot swap
    def swap_index(self, new_index, generation: Optional[int] = None,
                   owned: bool = False) -> IndexHandle:
        """Install ``new_index`` atomically; returns the RETIRING handle
        (callers/tests can ``wait_drained`` on it). In-flight batches
        finish on the old index; new batches acquire the new one.
        ``owned=True`` (watcher loads) lets the engine release the
        index's resources when ITS handle later retires."""
        with self._handle_lock:
            old = self._handle
            gen = old.generation + 1 if generation is None else generation
            new_index, owned = self._place(new_index, owned)
            self._handle = IndexHandle(new_index, generation=gen,
                                       on_retire=self._on_handle_retired,
                                       owned=owned)
        self.stats.record_swap()
        old.retire()
        return old

    def _on_handle_retired(self, handle: IndexHandle) -> None:
        if handle.owned:                # engine-loaded: release resources
            close = getattr(handle.index, "close", None)
            if close is not None:       # e.g. ShardedIndex probe pool
                close()
            handle.index = None         # its device memory goes with it
        logger.info("index generation %d drained and retired",
                    handle.generation)

    def _watch_loop(self) -> None:
        """Poll ``index_dir`` for a newer generation; load + pre-warm it
        off the serving path, then swap."""
        from repro_torch.core.persist import (artifact_generation,
                                              load_artifact)
        while not self._stop:
            time.sleep(self.poll_interval_s)
            try:
                gen = artifact_generation(self.index_dir)
                if gen <= self._handle.generation:
                    continue
                new_index = load_artifact(self.index_dir, mmap=True,
                                          device=self.device)
                # place BEFORE prewarm so every replica lane is warm the
                # moment the swap lands (swap_index's _place is then a
                # no-op on the already-wrapped index)
                new_index, owned = self._place(new_index, True)
                self._prewarm_index(new_index)
                self.swap_index(new_index, generation=gen, owned=owned)
            except Exception:               # noqa: BLE001 — keep serving
                logger.exception("hot-swap attempt failed; serving "
                                 "continues on generation %d",
                                 self._handle.generation)

    def _prewarm_index(self, index) -> None:
        """Search each bucket shape once on ``index`` before it takes
        traffic: builds its lazy device views and loads every kernel
        library its path launches, so the first batch after a start or
        a swap pays no cold start (and ``CompileCounter`` stays 0)."""
        cfg = getattr(self.searcher, "cfg", None)
        if cfg is None:                     # minimal searchers skip prewarm
            return
        L = cfg.query_maxlen - 2
        enc1 = self.searcher.encode_queries(np.ones((1, L), np.int32))
        # a replicated index warms every distinct copy (warm_shapes)
        run = (index.warm_shapes if self.n_replicas > 1
               else index.search_batch)
        for b in self.buckets:
            run(enc1.expand((b,) + tuple(enc1.shape[1:])).contiguous(),
                k=self.default_k)

    # ------------------------------------------------------------- batcher
    def _pop_coalesced(self):
        """Block for the first waiting slice, then coalesce until the
        batch is full, the oldest request's deadline lapses, or the next
        request's k differs. Returns (slices, reason) or None on stop."""
        with self._queue_cond:
            if not self._queue_cond.wait_for(
                    lambda: self._queue or self._stop, timeout=0.1):
                return None
            if self._stop and (self._abandon or not self._queue):
                return None          # abandoned backlog: stop() sweeps it
            head = self._queue[0]
            # The clock starts when the batcher is actually free to
            # flush (admission control may have held it while the
            # pipeline was full): a request that already waited out its
            # deadline behind a slow batch still gets a real coalescing
            # window now — its staged batch could not have started any
            # sooner anyway, so this adds batching, not latency.
            deadline = max(head.enqueue_t, time.perf_counter()
                           - self.max_wait_s * 0.5) + self.max_wait_s
            batch: List[_Slice] = []
            total = 0
            kk = head.future.k
            reason = None
            while True:
                while self._queue and total < self.max_batch:
                    sl = self._queue[0]
                    if sl.future.k != kk:
                        reason = "k_switch"
                        break
                    room = self.max_batch - total
                    if sl.n <= room:
                        batch.append(self._queue.popleft())
                        total += sl.n
                    else:                   # split: rows [lo, lo+room)
                        part = _Slice(sl.future, sl.lo, room, sl.enqueue_t)
                        sl.lo += room
                        sl.n -= room
                        batch.append(part)
                        total += room
                if reason == "k_switch":
                    break
                if total >= self.max_batch:
                    reason = "full"
                    break
                now = time.perf_counter()
                if now >= deadline or self._stop:
                    reason = "drain" if self._stop else "deadline"
                    break
                self._queue_cond.wait(timeout=min(deadline - now, 0.05))
            if batch:
                self._pending += 1      # resolved in _batch_done
            if not self._queue:
                self._queue_cond.notify_all()   # wake stop(drain=True)
            return batch, kk, reason

    def _batch_done(self) -> None:
        with self._queue_cond:
            self._pending -= 1
            self._queue_cond.notify_all()       # wake stop(drain=True)

    def _batcher_loop(self) -> None:
        try:
            self._batch_loop()
        finally:
            # search lanes exit only once no batch can be staged any more
            # (a lane that left on the stop flag alone could strand the
            # batcher's last, drained batch)
            with self._staged_cond:
                self._batcher_done = True
                self._staged_cond.notify_all()

    def _batch_loop(self) -> None:
        while True:
            # Admission control: coalesce ONLY when the pipeline can
            # accept the batch. While the search stage is busy, waiting
            # requests stay in the queue where late arrivals can still
            # join them — so under backlog, flushes fill toward
            # max_batch instead of staging half-full padded batches the
            # device would serve at full-bucket cost. (Single batcher
            # thread, so the room observed here cannot be stolen.)
            with self._staged_cond:
                if not self._staged_cond.wait_for(
                        lambda: len(self._staged) < self._staged_cap
                        or self._stop, timeout=0.1):
                    continue
                if self._stop and not self._queue:
                    return
            popped = self._pop_coalesced()
            if popped is None:
                if self._stop:
                    return
                continue
            batch, kk, reason = popped
            if not batch:
                continue
            try:
                toks = np.concatenate(
                    [sl.future._tokens[sl.lo:sl.lo + sl.n] for sl in batch])
                t_dequeue = time.perf_counter()
                waits = [t_dequeue - sl.enqueue_t for sl in batch]
                enc = self.searcher.encode_queries(toks)   # on the card
                n = len(enc)
                bucket = bucket_for(n, self.buckets)
                if bucket > n:
                    # pad up to the bucket by REPEATING the last real
                    # row: stage 1 then does normal work for the pad
                    # rows (an all-zero query can blow up threshold-based
                    # probing), and stage 2 reads only its own row
                    enc = torch.cat([enc, enc[-1:].expand(
                        (bucket - n,) + tuple(enc.shape[1:]))])
                staged = (enc, n, kk, batch, reason, waits)
            except BaseException as e:      # noqa: BLE001
                for sl in batch:
                    sl.future._fail(e)
                self.stats.record_failed(sum(sl.n for sl in batch))
                self._batch_done()
                continue
            if self._inline:                # depth 1: no handoff at all
                self._serve_staged(staged)
                continue
            with self._staged_cond:
                self._staged.append(staged)     # room reserved above
                self._staged_cond.notify_all()

    # -------------------------------------------------------------- search
    def _serve_staged(self, staged, replica: int = 0) -> None:
        """Run stage 2 for one encoded microbatch and resolve its
        futures (called from a search lane thread, or inline from the
        batcher at pipeline depth 1). ``replica`` picks the lane a
        routed index serves this batch on — every lane is bitwise
        identical, so routing is purely a throughput decision."""
        enc, n, kk, batch, reason, waits = staged
        try:
            with self._handle_lock:
                handle = self._handle
                index = handle.acquire()
            try:
                search_on = getattr(index, "search_batch_on", None)
                if search_on is not None:
                    S, I = search_on(replica, enc, k=kk)
                else:
                    S, I = index.search_batch(enc, k=kk)
            except BaseException as e:      # noqa: BLE001
                for sl in batch:
                    sl.future._fail(e)
                self.stats.record_failed(sum(sl.n for sl in batch))
                return
            finally:
                handle.release()
            S, I = np.asarray(S)[:n], np.asarray(I)[:n]     # host copies
            lo = 0
            for sl in batch:
                sl.future._fill(sl.lo, S[lo:lo + sl.n], I[lo:lo + sl.n])
                lo += sl.n
            self.stats.record_batch(n, len(enc), reason, waits,
                                    handle.generation, replica=replica)
        finally:
            self._batch_done()

    def _search_loop(self, replica: int = 0) -> None:
        while True:
            with self._staged_cond:
                if not self._staged_cond.wait_for(
                        lambda: self._staged or self._batcher_done,
                        timeout=0.1):
                    continue
                if not self._staged:
                    return          # the batcher has exited: nothing left
                staged = self._staged.popleft()
                self._staged_cond.notify_all()
            self._serve_staged(staged, replica=replica)


# ---------------------------------------------------------------------------
# Open-loop load generation (Poisson arrivals)
# ---------------------------------------------------------------------------
def run_open_loop(engine: ServingEngine, q_tokens: np.ndarray,
                  arrival_qps: float, n_queries: int, k: int = 10,
                  seed: int = 0,
                  on_halfway: Optional[Callable[[], None]] = None,
                  collect_results: bool = False) -> dict:
    """Fire ``n_queries`` single-query requests at the engine with
    Poisson (exponential inter-arrival) timing and wait for all results.

    Closed-loop replay hides queueing: the next query only leaves when
    the previous returns, so reported percentiles are *service* time.
    Open-loop arrivals measure what a user sees at a given offered load
    — queue wait included — which is the number tail-latency SLOs are
    written against. Returns achieved QPS + end-to-end latency
    percentiles (batcher internals live in ``engine.stats``).

    ``on_halfway`` fires once, mid-stream — benchmarks use it to
    republish the index and exercise a hot swap under load.
    ``collect_results`` adds a ``results`` list of per-request
    ``(scores, ids)`` (None where a request errored) so callers can
    assert parity against a direct ``search_batch``.

    Arrivals are scheduled at ABSOLUTE times; the submitter sleeps to
    the next scheduled arrival and then drains every due arrival in a
    catch-up loop, so a host stall delays a burst but never lowers the
    offered rate. Latency is measured from each request's *scheduled*
    arrival, so submitter lateness counts against the tail instead of
    being coordinated-omission'd away.
    """
    rng = np.random.default_rng(seed)
    sched = np.cumsum(rng.exponential(1.0 / arrival_qps, size=n_queries))
    futs: List[Optional[SearchFuture]] = [None] * n_queries
    t0 = time.perf_counter()
    i = 0
    while i < n_queries:
        delay = (t0 + sched[i]) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        now = time.perf_counter() - t0
        while i < n_queries and sched[i] <= now:    # catch-up burst
            # fired inside the burst loop: a stall-induced burst that
            # submits through the halfway point must not skip it
            if on_halfway is not None and i >= n_queries // 2:
                on_halfway()
                on_halfway = None
            futs[i] = engine.submit(q_tokens[i % len(q_tokens)][None],
                                    k=k)
            i += 1
    errors = 0
    lat = []
    results = []
    for i, f in enumerate(futs):
        try:
            results.append(f.result(timeout=120.0))
            lat.append(f.done_t - (t0 + sched[i]))
        except Exception:                   # noqa: BLE001
            results.append(None)
            errors += 1
    wall = time.perf_counter() - t0
    lat_ms = np.asarray(lat, np.float64) * 1e3
    out = {
        "arrival_qps": float(arrival_qps),
        "n_queries": int(n_queries),
        "errors": int(errors),
        "achieved_qps": float(len(lat) / wall) if wall > 0 else 0.0,
        "latency_p50_ms": (float(np.percentile(lat_ms, 50))
                           if lat_ms.size else 0.0),
        "latency_p99_ms": (float(np.percentile(lat_ms, 99))
                           if lat_ms.size else 0.0),
        "latency_mean_ms": (float(lat_ms.mean()) if lat_ms.size else 0.0),
    }
    if collect_results:
        out["results"] = results
    return out
