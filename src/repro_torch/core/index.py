"""Late-interaction index over per-document token vectors (PLAID backend).

Counterpart of ``src/repro/core/index.py`` ``MultiVectorIndex`` for the
port's slice: ``add`` on an empty index (codec training + PLAID build),
``set_codec``, the two-stage batch engine (``candidates`` -> packed
``rerank``), ``scored_candidates``, ``search_batch`` and ``n_vectors``.
Not ported yet (ROADMAP queue 1): the flat and hnsw backends, ``add``
after the build, ``delete``, persistence, and the host probe path with
the dense corpus-wide fallback — a query that would need them raises
``NotImplementedError``.

``impl`` on the search methods selects the kernels' plain versions
(``"ref"``); only the tests and ``chip_smoke.py`` pass it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ivf import train_centroids
from repro_torch.core.maxsim import topk_with_pads
from repro_torch.core.plaid import (PLAIDIndex, _UNPORTED,
                                    build_plaid_index,
                                    maxsim_packed_rerank_store,
                                    plaid_candidates)
from repro_torch.core.quantization import ResidualCodec, train_codec
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
    device: DeviceLike = None

    _plaid: Optional[PLAIDIndex] = field(default=None, repr=False)
    _preset_codec: Optional[ResidualCodec] = field(default=None, repr=False)

    def __post_init__(self):
        if self.backend != "plaid":
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet (ROADMAP "
                f"queue 1); the port builds 'plaid'")
        if int(self.quant_bits) not in (2, 4):
            raise ValueError(f"quant_bits must be 2 or 4, got "
                             f"{self.quant_bits!r}")
        self.device = resolve_device(self.device)

    @property
    def n_docs(self) -> int:
        return self._plaid.n_docs if self._plaid is not None else 0

    # ------------------------------------------------------------------ build
    def set_codec(self, codec: ResidualCodec) -> None:
        """Use this codec instead of training one on ``add``."""
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
        if self._plaid is not None:
            raise NotImplementedError(
                "add after the build is not ported yet (ROADMAP queue 1)")
        lens = np.asarray(lens, np.int64)
        if len(lens) == 0:
            return np.zeros((0,), np.int64)
        flat = flat.to(self.device).float()
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
        self._plaid = build_plaid_index(flat, lens, codec,
                                             self.doc_maxlen)
        return np.arange(len(lens))

    # ------------------------------------------------- two-stage batch engine
    def candidates(self, qs: torch.Tensor,
                   q_mask: Optional[torch.Tensor] = None, impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 1: qs [Nq, Lq, dim] -> (cand [Nq, C], mask [Nq, C])."""
        return plaid_candidates(self._plaid, self._queries(qs),
                                nprobe=self.nprobe, t_cs=self.t_cs,
                                ndocs=self.ndocs, q_mask=q_mask, impl=impl)

    def rerank(self, qs: torch.Tensor, cand: torch.Tensor,
               cand_mask: torch.Tensor,
               q_mask: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
        """Stage 2: exact MaxSim from packed codes -> scores [Nq, C]."""
        qs = self._queries(qs)
        qm = (torch.ones(qs.shape[:2], dtype=torch.bool, device=self.device)
              if q_mask is None else q_mask.to(self.device, torch.bool))
        return maxsim_packed_rerank_store(self._plaid, qs, qm, cand,
                                          cand_mask, impl=impl)

    def scored_candidates(self, qs: torch.Tensor,
                          q_mask: Optional[torch.Tensor] = None,
                          impl: str = "auto"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both stages, no top-k -> (scores [Nq, C], cand [Nq, C])."""
        cand, cand_mask = self.candidates(qs, q_mask, impl)
        if cand.shape[1] >= self.n_docs:     # the plan rules this out
            raise NotImplementedError(_UNPORTED)
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
        if self._plaid is None:
            raise RuntimeError("empty index: add documents first")
        return torch.as_tensor(qs, device=self.device).float()

    # ------------------------------------------------------------------ stats
    def n_vectors(self) -> int:
        return self._plaid.n_vectors if self._plaid is not None else 0

    def device_bytes(self) -> int:
        return self._plaid.device_bytes() if self._plaid is not None else 0
