"""Late-interaction index over per-document token vectors (flat | HNSW |
PLAID).

Counterpart of ``src/repro/core/index.py`` ``MultiVectorIndex``: ``add``
(flat: the ``DocStore``; hnsw: the store plus a token-level HNSW graph
on the host; plaid: codec training and the PLAID build on the first add,
``PLAIDIndex.add_flat`` with the same codec after it), lazy ``delete`` (the
``deleted`` set, the store's ``live`` mask, the graph's deleted tokens;
plaid filters dead docs at candidate time), ``set_codec``, the two-stage
batch engine (``candidates`` -> ``rerank``), ``scored_candidates`` with
the dense corpus-wide dispatch, ``search_batch`` / ``search``, and
``save``/``load`` (``core/persist.py``).

Stage 1 is the PLAID probe on the device (or its host path), hnsw's
token probes on the host with the candidate-set union, or for flat the
whole live corpus; stage 2 is the ``maxsim_packed`` kernel (plaid) or
the ``maxsim_rerank`` kernel reading the candidates from the store in
place (hnsw, and plaid with ``packed_rerank=False``), or the all-pairs
``maxsim`` scan where a slate reaches ``n_docs``.

Serving toggles, never persisted: ``packed_rerank`` (plaid rerank from
packed codes, or from the f32 reconstruction store) and
``probe_kernel`` (``"auto"``/``"device"``/``"host"`` candidate path).
The pooled cascade is its own class (``retrieval/cascade.py``).
``warm_shapes`` is a no-op (PyTorch does not trace per shape);
``candidate_widths`` gives the slate widths a batch shape can reach (the
reference's engine warmup compiles each; here no search path needs it).

``impl`` on the search methods selects the kernels' plain versions
(``"ref"``); only the tests and ``chip_smoke.py`` pass it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.docstore import DocStore, pad_candidate_sets
from repro_torch.core.hnsw import HNSW
from repro_torch.core.ivf import train_centroids
from repro_torch.core.maxsim import (maxsim_all_docs, maxsim_rerank_store,
                                     topk_with_pads)
from repro_torch.core.plaid import (PLAIDIndex, PROBE_KERNELS,
                                    build_plaid_index, device_probe_plan,
                                    maxsim_packed_rerank_store,
                                    plaid_candidates)
from repro_torch.core.quantization import ResidualCodec, train_codec
from repro_torch.core.spec import BACKENDS, INDEX_PARAM_KEYS
from repro_torch.device import DeviceLike, resolve_device

# construction knobs shared by persistence and sharding: the defining
# copy is ``core/spec.py``'s, re-exported under the reference's names
PARAM_KEYS = INDEX_PARAM_KEYS


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
    # HNSW params (paper Appendix A)
    hnsw_m: int = 12
    hnsw_ef_construction: int = 200
    hnsw_candidates: int = 1024    # token hits gathered before doc rerank
    packed_rerank: bool = True
    probe_kernel: str = "auto"
    device: DeviceLike = None

    deleted: set = field(default_factory=set)
    _store: Optional[DocStore] = field(default=None, repr=False)
    _hnsw: Optional[HNSW] = field(default=None, repr=False)
    _hnsw_vec2doc: Optional[np.ndarray] = field(default=None, repr=False)
    _plaid: Optional[PLAIDIndex] = field(default=None, repr=False)
    _preset_codec: Optional[ResidualCodec] = field(default=None, repr=False)
    _live_dev_cache: Optional[torch.Tensor] = field(default=None, repr=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if int(self.quant_bits) not in (2, 4):
            raise ValueError(f"quant_bits must be 2 or 4, got "
                             f"{self.quant_bits!r}")
        if self.probe_kernel not in PROBE_KERNELS:
            raise ValueError(f"probe_kernel must be one of {PROBE_KERNELS}, "
                             f"got {self.probe_kernel!r}")
        self.device = resolve_device(self.device)
        if self.backend != "plaid":
            self._store = DocStore(self.dim, self.doc_maxlen, self.device)

    # ------------------------------------------------------------ doc store
    @property
    def store(self) -> DocStore:
        """What dense scoring and the f32 rerank read: flat's and hnsw's
        raw vectors; plaid's reconstruction cache (built on first
        touch)."""
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

    @property
    def docs(self) -> List[torch.Tensor]:
        """Per-doc vectors, deleted docs included (plaid: the codec's
        reconstructions, which builds the reconstruction store)."""
        if self.backend == "plaid":
            return self.store.docs_list() if self._plaid is not None else []
        return self._store.docs_list()

    def _live(self) -> np.ndarray:
        """[n_docs] bool: docs that can still be returned (flat, hnsw:
        the store's mask; plaid: not in ``deleted``)."""
        if self._store is not None:
            return self._store.live.copy()
        live = np.ones(self.n_docs, bool)
        if self.deleted:
            live[np.fromiter(self.deleted, np.int64)] = False
        return live

    def _live_dev(self) -> torch.Tensor:
        """The live mask on the device, shipped once per mutation epoch:
        every build, add, delete and load resets it."""
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
        """doc_vectors: list of [n_i, dim] unit vectors -> doc ids."""
        if len(doc_vectors) == 0:
            return np.zeros((0,), np.int64)
        flat = torch.cat([torch.as_tensor(v, device=self.device).float()
                          .reshape(-1, self.dim) for v in doc_vectors])
        return self.add_flat(flat, [len(v) for v in doc_vectors])

    def add_flat(self, flat: torch.Tensor, lens) -> np.ndarray:
        """The same from doc-major rows [n_vectors, dim] and per-doc
        counts [n_docs] (what the Indexer's compaction yields)."""
        lens = np.asarray(lens, np.int64)
        if len(lens) == 0:
            return np.zeros((0,), np.int64)
        flat = flat.to(self.device).float()
        ids = np.arange(self.n_docs, self.n_docs + len(lens))
        self._live_dev_cache = None
        if self.backend == "plaid":
            self._add_plaid(flat, lens)
        else:
            self._store.add_flat(flat, lens)
            if self.backend == "hnsw":
                self._add_hnsw(flat, lens, ids)
        return ids

    def _add_hnsw(self, flat: torch.Tensor, lens: np.ndarray,
                  ids: np.ndarray) -> None:
        """Insert the token vectors into the host graph (in order, as
        the reference does, so both build the same graph)."""
        if self._hnsw is None:
            self._hnsw = HNSW(self.dim, m=self.hnsw_m,
                              ef_construction=self.hnsw_ef_construction)
            self._hnsw_vec2doc = np.zeros((0,), np.int64)
        self._hnsw.add(flat.cpu().numpy())
        self._hnsw_vec2doc = np.concatenate(
            [self._hnsw_vec2doc, np.repeat(ids, lens)])

    def _add_plaid(self, flat: torch.Tensor, lens: np.ndarray) -> None:
        if self._plaid is not None:
            self._plaid.add_flat(flat, lens)
            return
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

    def delete(self, doc_ids) -> None:
        """Lazy delete: the docs drop out of every search; their bytes
        go at the next ``save`` (compacted artifact)."""
        ids = np.asarray(doc_ids, np.int64).ravel()
        self.deleted.update(int(i) for i in ids)
        if self.backend == "hnsw" and self._hnsw is not None:
            self._hnsw.delete(np.nonzero(np.isin(self._hnsw_vec2doc,
                                                 ids))[0])
        if self._store is not None:
            self._store.delete(ids)
        self._live_dev_cache = None
        # plaid filters deleted ids at candidate time

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
        if self.backend == "hnsw":
            return self._hnsw_candidates(qs, q_mask)
        use_dev, _ = self._probe_plan(qs.shape[1])
        live = self._live_dev() if use_dev else self._live()
        return plaid_candidates(self._plaid, qs, nprobe=self.nprobe,
                                t_cs=self.t_cs, ndocs=self.ndocs, live=live,
                                q_mask=q_mask,
                                probe_kernel=self.probe_kernel, impl=impl)

    def _hnsw_candidates(self, qs: torch.Tensor,
                         q_mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token probes of the host graph (``hnsw_candidates // Lq`` hits
        a query token, at least 8), then each query's sorted unique live
        docs, padded (``pad_candidate_sets``) -> (cand, mask) on the
        device."""
        Nq, Lq = qs.shape[:2]
        per_tok = max(self.hnsw_candidates // max(Lq, 1), 8)
        vec_ids = self._hnsw.probe_tokens(
            qs.reshape(Nq * Lq, self.dim).cpu().numpy(), per_tok)
        hit = vec_ids >= 0                               # [Nq*Lq, per_tok]
        if q_mask is not None:     # masked tokens probe nothing
            hit &= q_mask.cpu().numpy().astype(bool).reshape(Nq * Lq, 1)
        qidx = np.repeat(np.arange(Nq), Lq * per_tok)[hit.ravel()]
        docs = self._hnsw_vec2doc[vec_ids[hit]]
        n = max(self.n_docs, 1)
        qd = np.unique(qidx * np.int64(n) + docs)
        qidx, docs = qd // n, qd % n
        keep = self._live()[docs]
        cand, mask = pad_candidate_sets(qidx[keep], docs[keep], Nq)
        return (torch.from_numpy(cand).to(self.device),
                torch.from_numpy(mask).to(self.device))

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
        with record_function("search.topk"):
            return topk_with_pads(scores, cand, k)

    def candidate_widths(self, qs) -> Tuple[List[int], bool]:
        """Slate widths a stream at this batch shape can reach:
        ``(widths, dense)``, the geometric pad ladder {32, 64, ...}
        (``pad_candidate_sets``) capped by the stage-1 budget (plaid:
        ndocs before the prune; hnsw: the token-probe hit bound) plus
        plaid's post-prune width, restricted to widths below ``n_docs``;
        ``dense`` says whether the corpus-wide dispatch is reachable. On
        plaid's device path, one static slate width."""
        if self.n_docs == 0:
            return [], False
        if self.backend == "flat":
            return [], True                 # dense only
        block = 32                          # pad_candidate_sets block
        if self.backend == "plaid":
            use_dev, geom = self._probe_plan(qs.shape[1])
            if use_dev:
                return [geom[3]], False
            cap = min(self.n_docs, self.ndocs)
        else:
            Lq = max(qs.shape[1], 1)
            per_tok = max(self.hnsw_candidates // Lq, 8)
            cap = min(self.n_docs, per_tok * Lq)
        widths = set()
        C = block
        while C < cap:
            widths.add(C)
            C <<= 1
        widths.add(C)                       # first ladder value >= cap
        if self.backend == "plaid":         # post-prune width
            widths.add(-(-min(self.ndocs, self.n_docs) // block) * block)
        return (sorted(w for w in widths if w < self.n_docs),
                max(widths) >= self.n_docs)

    def warm_shapes(self, qs, k: int = 10) -> None:
        """No-op: PyTorch does not trace per shape, so no candidate width
        needs warming before traffic (the reference compiles each)."""

    def search(self, q, k: int = 10, impl: str = "auto"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """q [Lq, dim] query token vectors -> (scores [<=k], ids [<=k])."""
        S, I = self.search_batch(torch.as_tensor(q)[None], k=k, impl=impl)
        valid = I[0] >= 0
        return S[0][valid], I[0][valid]

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

    def nbytes(self) -> int:
        """The reference's footprint: hnsw's graph (fp16 vectors and
        edges), plaid's ``PLAIDIndex.nbytes``, flat's fp16 live docs."""
        if self.backend == "hnsw" and self._hnsw is not None:
            return self._hnsw.nbytes()
        if self.backend == "plaid":
            return self._plaid.nbytes() if self._plaid is not None else 0
        return self._store.nbytes(bytes_per_dim=2, live_only=True)

    def device_bytes(self) -> int:
        if self.backend == "plaid":
            return self._plaid.device_bytes() if self._plaid is not None \
                else 0
        return self._store.device_nbytes()
