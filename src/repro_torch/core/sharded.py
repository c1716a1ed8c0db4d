"""ShardedIndex: capped MultiVectorIndex shards behind one logical index.

Counterpart of ``src/repro/core/sharded.py``. A ``ShardedIndex`` owns
an ordered list of ``MultiVectorIndex`` shards and the global doc-id
partition:

  * shard ``s`` owns the contiguous global ids
    ``[doc_base[s], doc_base[s] + shards[s].n_docs)``, assigned in
    stream order, so a sharded build numbers documents as the
    monolithic build does;
  * ``add`` appends to the last shard and spills into a new one at
    ``shard_max_vectors`` (documents stay whole; earlier shards never
    grow); a new plaid shard gets the index's one codec (``set_codec``);
  * ``delete`` maps global ids to their shards with one ``searchsorted``;
  * ``search_batch`` runs each live shard's two stages
    (``MultiVectorIndex.scored_candidates``: probe, prune and rerank
    through the kernels) and its top-k on the device (``topk_shard``,
    global ids), on a thread pool when more than one shard is live;
    the [Nq, k] blocks are collected in shard order, concatenated and
    reduced by one ``topk_with_pads``. A shard contributes at most k
    winners and ties go to the lowest position, so the merge equals one
    top-k over every shard's slate.

Parity contract (the reference's): with every backend's candidate stage
exhaustive (flat always; hnsw ``hnsw_candidates``, plaid ``nprobe`` and
``ndocs`` generous) and one codec shared by the plaid shards and the
monolithic index, the results are the monolithic index's. Elsewhere
``ndocs`` prunes per shard, so sharded and monolithic slates differ.

The shards probe concurrently on the legacy default stream, so their
device work is serialised in launch order and needs no events; the
kernels' launch counters are locked. ``warm_shapes`` is a no-op:
PyTorch does not trace per shape.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.maxsim import topk_shard, topk_with_pads
from repro_torch.core.spec import BACKENDS, INDEX_PARAM_KEYS
from repro_torch.device import DeviceLike, resolve_device

SHARD_PARAM_KEYS = INDEX_PARAM_KEYS


def _resolve_probe_threads(probe_threads: int) -> int:
    """0 = auto: ``min(8, cpu_count)``."""
    pt = int(probe_threads)
    if pt < 0:
        raise ValueError(f"probe_threads must be >= 0 (0 = auto), "
                         f"got {probe_threads!r}")
    return pt if pt > 0 else min(8, os.cpu_count() or 1)


class ShardedIndex:
    """One logical multi-vector index over capped shards."""

    def __init__(self, dim: int, backend: str = "plaid",
                 shard_max_vectors: int = 0, probe_threads: int = 0,
                 device: DeviceLike = None, **index_kw):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        unknown = set(index_kw) - set(SHARD_PARAM_KEYS)
        if unknown:
            raise ValueError(f"unknown shard params {sorted(unknown)}")
        self.device = resolve_device(device)
        self.dim = dim
        self.backend = backend
        self.shard_max_vectors = int(shard_max_vectors)    # 0 = uncapped
        self.index_kw: Dict = dict(index_kw)
        self.shards: List[MultiVectorIndex] = []
        self.doc_base: List[int] = []
        self.last_probe_s: List[float] = []
        # the spec value (0 = auto) persists; the resolved count sizes
        # the pool
        self.probe_threads = _resolve_probe_threads(probe_threads)
        self.probe_threads_cfg = int(probe_threads)
        self.shard_devices: Optional[List[torch.device]] = None
        self._closed = False
        # made here (no thread starts before the first submit), so
        # concurrent first searches cannot race a lazy init
        self._pool = ThreadPoolExecutor(
            max_workers=max(self.probe_threads, 1),
            thread_name_prefix="shard-probe")

    @classmethod
    def from_parts(cls, shards: Sequence[MultiVectorIndex],
                   doc_base: Sequence[int], shard_max_vectors: int = 0,
                   probe_threads: int = 0,
                   device: DeviceLike = None) -> "ShardedIndex":
        """Adopt built shards; ``doc_base`` must be their cumulative doc
        counts (base[0] == 0, base[s+1] == base[s] + shards[s].n_docs).
        The device is the first shard's unless given."""
        if len(shards) != len(doc_base):
            raise ValueError(f"{len(shards)} shards, {len(doc_base)} bases")
        first = shards[0] if len(shards) else None
        kw = ({k: getattr(first, k) for k in SHARD_PARAM_KEYS}
              if first is not None else {})
        if device is None and first is not None:
            device = first.device
        self = cls(dim=(first.dim if first is not None else 0),
                   backend=(first.backend if first is not None else "flat"),
                   shard_max_vectors=shard_max_vectors,
                   probe_threads=probe_threads, device=device, **kw)
        base = 0
        for s, b in zip(shards, doc_base):
            if s.backend != self.backend or s.dim != self.dim:
                raise ValueError("shards differ in backend or dim")
            if int(b) != base:
                raise ValueError(f"doc base {b} where {base} was expected")
            base += s.n_docs
        self.shards = list(shards)
        self.doc_base = [int(b) for b in doc_base]
        return self

    # ------------------------------------------------------------- topology
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_docs(self) -> int:
        if not self.shards:
            return 0
        return self.doc_base[-1] + self.shards[-1].n_docs

    def n_vectors(self) -> int:
        return sum(s.n_vectors() for s in self.shards)

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.shards)

    def device_bytes(self) -> int:
        """Device bytes of the query-time doc representation, summed."""
        return sum(s.device_bytes() for s in self.shards)

    def shard_of(self, doc_ids) -> np.ndarray:
        """Global doc ids -> owning shard (an empty input gives an empty
        int64 array, even on an empty index)."""
        ids = np.asarray(doc_ids, np.int64)
        if ids.size == 0:
            return np.zeros(ids.shape, np.int64)
        if not self.shards:
            raise IndexError("empty sharded index")
        if ids.min() < 0 or ids.max() >= self.n_docs:
            raise IndexError(f"doc id out of range [0, {self.n_docs})")
        return np.searchsorted(np.asarray(self.doc_base, np.int64), ids,
                               side="right") - 1

    def codec(self):
        """The shared plaid residual codec (None for other backends or
        before the first add)."""
        for s in self.shards:
            if s._plaid is not None:
                return s._plaid.codec
        return None

    # ------------------------------------------------------------ placement
    def place(self, devices: Optional[Sequence]) -> None:
        """Pin shard ``s``'s probe to ``devices[s]`` (its thread's current
        CUDA device) and merge on the first live shard's; ``None``
        clears it. On one card: that device, repeated. The shards'
        tensors stay on the device they were built or loaded on."""
        if devices is None:
            self.shard_devices = None
            return
        devices = [torch.device(d) for d in devices]
        if len(devices) != len(self.shards):
            raise ValueError(f"{len(devices)} devices for "
                             f"{len(self.shards)} shards")
        self.shard_devices = devices

    def _shard_device(self, i: int) -> Optional[torch.device]:
        return self.shard_devices[i] if self.shard_devices else None

    def set_probe_threads(self, probe_threads: int) -> None:
        """Re-size the probe pool; in-flight probes finish on the old
        one."""
        new = _resolve_probe_threads(probe_threads)
        old = self._pool
        self._pool = ThreadPoolExecutor(
            max_workers=max(new, 1), thread_name_prefix="shard-probe")
        self.probe_threads = new
        self.probe_threads_cfg = int(probe_threads)
        old.shutdown(wait=False)

    def set_probe_kernel(self, probe_kernel: str) -> None:
        """The plaid candidate path (``"auto"``, ``"device"``, ``"host"``)
        of every shard; runtime-only, never persisted."""
        from repro_torch.core.plaid import PROBE_KERNELS
        if probe_kernel not in PROBE_KERNELS:
            raise ValueError(f"probe_kernel must be one of {PROBE_KERNELS}, "
                             f"got {probe_kernel!r}")
        for shard in self.shards:
            shard.probe_kernel = probe_kernel

    # ---------------------------------------------------------------- build
    def _new_shard(self) -> MultiVectorIndex:
        shard = MultiVectorIndex(dim=self.dim, backend=self.backend,
                                 device=self.device, **self.index_kw)
        if self.backend == "plaid":
            codec = self.codec()
            if codec is not None:       # one quantization model an index
                shard.set_codec(codec)
        self.doc_base.append(self.n_docs)
        self.shards.append(shard)
        self.shard_devices = None       # growth drops placement
        return shard

    def add(self, doc_vectors) -> np.ndarray:
        """Append docs ([n_i, dim] each), spilling into new shards at
        ``shard_max_vectors``. Returns global ids, contiguous, in input
        order; an empty input returns an empty id array."""
        docs = [torch.as_tensor(v, device=self.device).float()
                .reshape(-1, self.dim) for v in doc_vectors]
        lens = [len(v) for v in docs]
        out: List[np.ndarray] = []
        i = 0
        while i < len(docs):
            shard = self.shards[-1] if self.shards else self._new_shard()
            cap = self.shard_max_vectors
            if cap:
                room = cap - shard.n_vectors()
                j, used = i, 0
                # docs are whole: an empty shard takes at least one
                while j < len(docs) and (used + lens[j] <= room or (
                        j == i and shard.n_docs == 0)):
                    used += lens[j]
                    j += 1
                if j == i:              # shard full: spill to a new one
                    self._new_shard()
                    continue
            else:
                j = len(docs)
            out.append(self.doc_base[-1] + shard.add(docs[i:j]))
            i = j
        return np.concatenate(out) if out else np.zeros((0,), np.int64)

    def delete(self, doc_ids) -> None:
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        owner = self.shard_of(ids)
        for s in np.unique(owner):
            self.shards[s].delete(ids[owner == s] - self.doc_base[s])

    # ---------------------------------------------------------- persistence
    def save(self, path: str, extra_meta: Optional[dict] = None) -> dict:
        """Root manifest + one artifact directory a shard
        (``core/persist.py``)."""
        from repro_torch.core import persist
        return persist.save_sharded(self, path, extra_meta=extra_meta)

    @classmethod
    def load(cls, path: str, mmap: bool = True,
             device: DeviceLike = None) -> "ShardedIndex":
        from repro_torch.core import persist
        return persist.load_sharded(path, mmap=mmap, device=device)

    # --------------------------------------------------------------- search
    def warm_shapes(self, qs, k: int = 10) -> None:
        """No-op: PyTorch does not trace per shape, so no candidate width
        needs warming before traffic (the reference compiles each)."""

    def _probe_shard(self, base: int, shard: MultiVectorIndex, qs, q_mask,
                     k: int, impl: str, dev: Optional[torch.device]):
        """One shard's top-k on the device with global ids, and its probe
        wall seconds: the unit the pool fans out."""
        t0 = time.perf_counter()
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        scores, cand = shard.scored_candidates(qs, q_mask, impl)
        top_s, top_i = topk_shard(scores, cand, k, base)
        return top_s, top_i, time.perf_counter() - t0

    def close(self) -> None:
        """Release the probe pool (idempotent). A closed index still
        serves, probing its shards one after another."""
        self._closed = True
        self._pool.shutdown(wait=False)

    @property
    def closed(self) -> bool:
        return self._closed

    def search_batch_with_stats(self, qs, k: int = 10,
                                q_mask: Optional[torch.Tensor] = None,
                                impl: str = "auto"
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           List[float]]:
        """``search_batch`` plus this call's per-shard probe seconds (0
        for an empty shard). Each live shard's probe, rerank and top-k
        run on the pool when more than one shard is live and
        ``probe_threads > 1``; the blocks are merged in shard order, so
        thread scheduling never changes the result."""
        Nq = len(qs)
        live = [(base, shard, self._shard_device(i))
                for i, (base, shard) in enumerate(zip(self.doc_base,
                                                      self.shards))
                if shard.n_docs > 0]
        if live:
            qs = torch.as_tensor(qs, device=live[0][1].device).float()
        if len(live) > 1 and self.probe_threads > 1 and not self._closed:
            futs = [self._pool.submit(self._probe_shard, base, shard, qs,
                                      q_mask, k, impl, dev)
                    for base, shard, dev in live]
            parts = [f.result() for f in futs]
        else:
            parts = [self._probe_shard(base, shard, qs, q_mask, k, impl, dev)
                     for base, shard, dev in live]
        it = iter(parts)
        probe_s = [0.0 if shard.n_docs == 0 else next(it)[2]
                   for shard in self.shards]
        if not parts:
            return (np.full((Nq, k), -np.inf, np.float32),
                    np.full((Nq, k), -1, np.int64), probe_s)
        md = parts[0][0].device             # merge on the first live shard's
        top_s = torch.cat([p[0].to(md) for p in parts], dim=1)
        top_i = torch.cat([p[1].to(md) for p in parts], dim=1)
        S, I = topk_with_pads(top_s, top_i, k)
        return S, I, probe_s

    def search_batch(self, qs, k: int = 10,
                     q_mask: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """qs [Nq, Lq, dim] -> host (scores [Nq, k], ids [Nq, k]), padded
        with -inf / -1; ``last_probe_s`` keeps this call's per-shard
        probe seconds (one assignment)."""
        S, I, probe_s = self.search_batch_with_stats(qs, k=k, q_mask=q_mask,
                                                     impl=impl)
        self.last_probe_s = probe_s
        return S, I

    def search(self, q, k: int = 10, impl: str = "auto"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """q [Lq, dim] -> (scores [<=k], ids [<=k])."""
        S, I = self.search_batch(torch.as_tensor(q)[None], k=k, impl=impl)
        valid = I[0] >= 0
        return S[0][valid], I[0][valid]
