"""Late-interaction index over per-document token vectors (flat | PLAID).

Counterpart of ``src/repro/core/index.py`` ``MultiVectorIndex`` for the
port's slice: ``add`` on an empty index (flat: the ``DocStore``; plaid:
codec training + PLAID build), ``set_codec``, the two-stage batch engine
(``candidates`` -> ``rerank``), ``scored_candidates`` with the dense
corpus-wide dispatch, ``search_batch``, ``save``/``load``
(``core/persist.py``), and liveness from a loaded artifact's dead docs.

Serving toggles, never persisted: ``packed_rerank`` (plaid rerank from
packed codes, or from the f32 reconstruction store) and
``probe_kernel`` (``"auto"``/``"device"``/``"host"`` candidate path).
The pooled cascade is its own class (``retrieval/cascade.py``). Not
ported yet (ROADMAP queue 1, item 4: index mutation, with the hnsw
backend): ``backend="hnsw"`` and ``add`` after the build raise
``NotImplementedError``; ``delete`` is absent (dead docs come only from
a loaded artifact).

``impl`` on the search methods selects the kernels' plain versions
(``"ref"``); only the tests and ``chip_smoke.py`` pass it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.docstore import DocStore
from repro_torch.core.ivf import train_centroids
from repro_torch.core.maxsim import (maxsim_all_docs, maxsim_rerank_store,
                                     topk_with_pads)
from repro_torch.core.plaid import (PLAIDIndex, PROBE_KERNELS,
                                    build_plaid_index, device_probe_plan,
                                    maxsim_packed_rerank_store,
                                    plaid_candidates)
from repro_torch.core.quantization import ResidualCodec, train_codec
from repro_torch.core.spec import BACKENDS, PORTED_BACKENDS
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class MultiVectorIndex:
    dim: int
    backend: str = "plaid"
    doc_maxlen: int = 256
    n_centroids: int = 256
    quant_bits: int = 2
    nprobe: int = 8
    t_cs: float = 0.3
    ndocs: int = 8192
    # hnsw knobs: carried for the manifest "params" (the hnsw backend is
    # not ported), at the reference's defaults
    hnsw_m: int = 12
    hnsw_ef_construction: int = 200
    hnsw_candidates: int = 1024
    packed_rerank: bool = True
    probe_kernel: str = "auto"
    device: DeviceLike = None

    deleted: set = field(default_factory=set)
    _store: Optional[DocStore] = field(default=None, repr=False)
    _plaid: Optional[PLAIDIndex] = field(default=None, repr=False)
    _preset_codec: Optional[ResidualCodec] = field(default=None, repr=False)
    _live_dev_cache: Optional[torch.Tensor] = field(default=None, repr=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend not in PORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet (ROADMAP "
                f"queue 1); the port builds {PORTED_BACKENDS}")
        if int(self.quant_bits) not in (2, 4):
            raise ValueError(f"quant_bits must be 2 or 4, got "
                             f"{self.quant_bits!r}")
        if self.probe_kernel not in PROBE_KERNELS:
            raise ValueError(f"probe_kernel must be one of {PROBE_KERNELS}, "
                             f"got {self.probe_kernel!r}")
        self.device = resolve_device(self.device)
        if self.backend == "flat":
            self._store = DocStore(self.dim, self.doc_maxlen, self.device)

    # ------------------------------------------------------------ doc store
    @property
    def store(self) -> DocStore:
        """What dense scoring and the f32 rerank read: flat's raw
        vectors; plaid's reconstruction cache (built on first touch)."""
        if self.backend == "plaid":
            if self._plaid is None:
                raise RuntimeError("empty index: add documents first")
            return self._plaid.recon_store()
        return self._store

    @property
    def n_docs(self) -> int:
        if self.backend == "plaid":
            return self._plaid.n_docs if self._plaid is not None else 0
        return self._store.n_docs

    def _live(self) -> np.ndarray:
        """[n_docs] bool: docs that can still be returned (flat: the
        store's mask; plaid: not in ``deleted``)."""
        if self._store is not None:
            return self._store.live.copy()
        live = np.ones(self.n_docs, bool)
        if self.deleted:
            live[np.fromiter(self.deleted, np.int64)] = False
        return live

    def _live_dev(self) -> torch.Tensor:
        """The live mask on the device, shipped once per load/build."""
        if self._live_dev_cache is None:
            self._live_dev_cache = torch.from_numpy(self._live()).to(
                self.device)
        return self._live_dev_cache

    def _probe_plan(self, Lq: int):
        if self.backend != "plaid" or self._plaid is None:
            return False, None
        return device_probe_plan(self._plaid, Lq, self.nprobe, self.ndocs,
                                 self.probe_kernel)

    # ------------------------------------------------------------------ build
    def set_codec(self, codec: ResidualCodec) -> None:
        """Use this codec instead of training one on ``add``."""
        if self.backend != "plaid":
            raise ValueError("set_codec needs the plaid backend")
        if self._plaid is not None:
            raise RuntimeError("codec must be preset before add")
        self._preset_codec = codec

    def add(self, doc_vectors: List[torch.Tensor]) -> np.ndarray:
        """doc_vectors: list of [n_i, dim] unit vectors -> doc ids. Only
        the first add (the build) is ported."""
        if len(doc_vectors) == 0:
            return np.zeros((0,), np.int64)
        flat = torch.cat([torch.as_tensor(v, device=self.device).float()
                          .reshape(-1, self.dim) for v in doc_vectors])
        return self.add_flat(flat, [len(v) for v in doc_vectors])

    def add_flat(self, flat: torch.Tensor, lens) -> np.ndarray:
        """The same build from doc-major rows [n_vectors, dim] and
        per-doc counts [n_docs] (what the Indexer's compaction yields)."""
        if self.n_docs:
            raise NotImplementedError(
                "add after the build is not ported yet (ROADMAP queue 1)")
        lens = np.asarray(lens, np.int64)
        if len(lens) == 0:
            return np.zeros((0,), np.int64)
        flat = flat.to(self.device).float()
        self._live_dev_cache = None
        if self.backend == "flat":
            return self._store.add_flat(flat, lens)
        codec = self._preset_codec
        if codec is None:
            k = min(self.n_centroids, len(flat))
            centroids = train_centroids(flat, k)
            codec = train_codec(flat, centroids, bits=self.quant_bits)
        codec = ResidualCodec(
            centroids=torch.as_tensor(codec.centroids, device=self.device),
            cutoffs=torch.as_tensor(codec.cutoffs, device=self.device),
            values=torch.as_tensor(codec.values, device=self.device),
            bits=codec.bits)
        self._plaid = build_plaid_index(flat, lens, codec, self.doc_maxlen)
        return np.arange(len(lens))

    # ------------------------------------------------------------ persistence
    def save(self, path: str, extra_meta: Optional[dict] = None) -> dict:
        """Write a ``FORMAT_VERSION`` artifact directory
        (``core/persist.py``); returns the manifest."""
        from repro_torch.core import persist
        return persist.save_index(self, path, extra_meta=extra_meta)

    @classmethod
    def load(cls, path: str, mmap: bool = True,
             device: DeviceLike = None) -> "MultiVectorIndex":
        """Reconstruct an index from a ``save``d (or JAX-written)
        artifact directory onto ``device``."""
        from repro_torch.core import persist
        return persist.load_index(path, mmap=mmap, device=device)

    # ------------------------------------------------- two-stage batch engine
    def candidates(self, qs: torch.Tensor,
                   q_mask: Optional[torch.Tensor] = None, impl: str = "auto"
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Stage 1: qs [Nq, Lq, dim] -> (cand [Nq, C], mask [Nq, C]);
        ``(None, None)`` for flat (every live doc is a candidate)."""
        if self.backend == "flat":
            return None, None
        qs = self._queries(qs)
        use_dev, _ = self._probe_plan(qs.shape[1])
        live = self._live_dev() if use_dev else self._live()
        return plaid_candidates(self._plaid, qs, nprobe=self.nprobe,
                                t_cs=self.t_cs, ndocs=self.ndocs, live=live,
                                q_mask=q_mask,
                                probe_kernel=self.probe_kernel, impl=impl)

    def rerank(self, qs: torch.Tensor, cand: Optional[torch.Tensor] = None,
               cand_mask: Optional[torch.Tensor] = None,
               q_mask: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
        """Stage 2: exact MaxSim -> scores [Nq, C] (-inf invalid), or
        with ``cand=None`` over the whole live corpus -> [Nq, n_docs]."""
        qs = self._queries(qs)
        qm = (torch.ones(qs.shape[:2], dtype=torch.bool, device=self.device)
              if q_mask is None else q_mask.to(self.device, torch.bool))
        if cand is None:
            d, dm = self.store.padded()
            scores = maxsim_all_docs(qs, qm, d, dm, impl=impl)
            return scores.masked_fill(
                ~self._live_dev()[None, :], float("-inf"))
        if self.backend == "plaid" and self.packed_rerank:
            return maxsim_packed_rerank_store(self._plaid, qs, qm, cand,
                                              cand_mask, impl=impl)
        return maxsim_rerank_store(self.store, qs, qm, cand, cand_mask,
                                   impl=impl)

    def _rerank_dense(self, qs, cand, cand_mask, q_mask,
                      impl: str = "auto") -> torch.Tensor:
        """Dense-candidate rerank, for a slate as wide as the corpus: one
        all-pairs scan, then each query's membership mask (scattered on
        the device) -> scores [Nq, n_docs] (-inf outside its set)."""
        scores = self.rerank(qs, None, None, q_mask, impl)
        n = self.n_docs
        member = torch.zeros((cand.shape[0], n + 1), dtype=torch.bool,
                             device=self.device)
        member.scatter_(1, torch.where(cand_mask, cand,
                                       torch.full_like(cand, n)), True)
        return scores.masked_fill(~member[:, :n], float("-inf"))

    def scored_candidates(self, qs: torch.Tensor,
                          q_mask: Optional[torch.Tensor] = None,
                          impl: str = "auto"
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Both stages, no top-k -> (scores [Nq, C], cand [Nq, C] or
        None when the scores are corpus-wide: flat, or a slate grown to
        ``n_docs``)."""
        cand, cand_mask = self.candidates(qs, q_mask, impl)
        if cand is not None and cand.shape[1] >= self.n_docs:
            return self._rerank_dense(qs, cand, cand_mask, q_mask,
                                      impl), None
        return self.rerank(qs, cand, cand_mask, q_mask, impl), cand

    def search_batch(self, qs: torch.Tensor, k: int = 10,
                     q_mask: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """qs [Nq, Lq, dim] -> host (scores [Nq, k], ids [Nq, k]),
        padded with -inf / -1."""
        Nq = len(qs)
        if self.n_docs == 0:
            return (np.full((Nq, k), -np.inf, np.float32),
                    np.full((Nq, k), -1, np.int64))
        scores, cand = self.scored_candidates(qs, q_mask, impl)
        return topk_with_pads(scores, cand, k)

    def _queries(self, qs) -> torch.Tensor:
        if self.n_docs == 0:
            raise RuntimeError("empty index: add documents first")
        return torch.as_tensor(qs, device=self.device).float()

    # ------------------------------------------------------------------ stats
    def n_vectors(self) -> int:
        if self.n_docs == 0:
            return 0
        lens = (np.diff(self._plaid.doc_offsets) if self.backend == "plaid"
                else self._store.doc_lengths())
        return int(lens[self._live()].sum())

    def device_bytes(self) -> int:
        if self.backend == "plaid":
            return self._plaid.device_bytes() if self._plaid is not None \
                else 0
        return self._store.device_nbytes()
