"""Pooled-cascade retrieval: a coarse pool level generates candidates, a
fine one reranks them.

Counterpart of ``src/repro/retrieval/cascade.py``. The cascade stores
every document twice, pooled at ``coarse_factor`` and at
``fine_factor``, each level in a device ``DocStore``:

  stage 1: all-pairs MaxSim over the coarse vectors of every doc (the
           ``maxsim`` kernel), then the top ``candidates`` per query
           (stable: ties go to the lower doc id, as ``jax.lax.top_k``);
  stage 2: MaxSim over the fine vectors of those candidates only (the
           ``maxsim_rerank`` kernel, reading them from the fine store in
           place), then the top-k.

Every query token counts as valid, as in the reference. ``build_cascade``
encodes the corpus once per pool level, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.docstore import DocStore
from repro_torch.core.maxsim import (maxsim_all_docs, maxsim_rerank_store,
                                     stable_topk, topk_with_pads)
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class CascadeIndex:
    dim: int
    coarse_factor: int = 6
    fine_factor: int = 2
    candidates: int = 32
    doc_maxlen: int = 256
    device: DeviceLike = None
    _coarse: Optional[DocStore] = field(default=None, repr=False)
    _fine: Optional[DocStore] = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._coarse = DocStore(self.dim, self.doc_maxlen, self.device)
        self._fine = DocStore(self.dim, self.doc_maxlen, self.device)

    @property
    def n_docs(self) -> int:
        return self._coarse.n_docs

    # per-doc views of the two stores (device tensors)
    @property
    def coarse_docs(self) -> List[torch.Tensor]:
        return self._coarse.docs_list()

    @property
    def fine_docs(self) -> List[torch.Tensor]:
        return self._fine.docs_list()

    def add(self, coarse: List[torch.Tensor],
            fine: List[torch.Tensor]) -> np.ndarray:
        """Per-doc pooled vectors at both levels ([n_i, dim] each) ->
        doc ids."""
        if len(coarse) != len(fine):
            raise ValueError(f"{len(coarse)} coarse docs but {len(fine)} "
                             f"fine docs")
        ids = self._coarse.add(coarse)
        self._fine.add(fine)
        return ids

    # ------------------------------------------------------------ persistence
    def save(self, path: str, extra_meta: Optional[dict] = None) -> dict:
        """Write both pool levels as one artifact (``core/persist.py``)."""
        from repro_torch.core import persist
        return persist.save_cascade(self, path, extra_meta=extra_meta)

    @classmethod
    def from_dir(cls, path: str, mmap: bool = True,
                 device: DeviceLike = None) -> "CascadeIndex":
        """Load a cascade artifact (written by either package)."""
        from repro_torch.core import persist
        return persist.load_cascade(path, mmap=mmap, device=device)

    # ---------------------------------------------------------------- search
    def search_batch(self, qs, k: int = 10, impl: str = "auto"
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """qs [Nq, Lq, dim] -> host (scores [Nq, k], ids [Nq, k]),
        padded with -inf / -1."""
        qs = torch.as_tensor(qs, device=self.device).float()
        Nq = qs.shape[0]
        n = self.n_docs
        if n == 0:
            return (np.full((Nq, k), -np.inf, np.float32),
                    np.full((Nq, k), -1, np.int64))
        qm = torch.ones(qs.shape[:2], dtype=torch.bool, device=self.device)
        cd, cm = self._coarse.padded()
        s1 = maxsim_all_docs(qs, qm, cd, cm, impl=impl)          # [Nq, n]
        _, cand = stable_topk(s1, min(max(self.candidates, k), n))
        s2 = maxsim_rerank_store(self._fine, qs, qm, cand,
                                 torch.ones_like(cand, dtype=torch.bool),
                                 impl=impl)                      # [Nq, C]
        return topk_with_pads(s2, cand, k)

    def warm_shapes(self, qs, k: int = 10) -> None:
        """No-op: PyTorch does not trace per shape (the reference runs one
        search to compile the cascade's shapes)."""

    def search(self, q, k: int = 10, impl: str = "auto"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """q [Lq, dim] -> (scores [<=k], ids [<=k])."""
        S, I = self.search_batch(torch.as_tensor(q)[None], k=k, impl=impl)
        valid = I[0] >= 0
        return S[0][valid], I[0][valid]

    # ----------------------------------------------------------------- stats
    def n_vectors(self) -> int:
        return (self._coarse.n_vectors(live_only=False)
                + self._fine.n_vectors(live_only=False))

    def stage1_vectors(self) -> int:
        """Vectors a full stage-1 scan touches (the per-query cost)."""
        return self._coarse.n_vectors(live_only=False)

    def device_bytes(self) -> int:
        return self._coarse.device_nbytes() + self._fine.device_nbytes()


def build_cascade(model, doc_tokens: np.ndarray, coarse_factor: int = 6,
                  fine_factor: int = 2, candidates: int = 32,
                  pool_method: str = "ward", encode_batch: int = 64,
                  device: DeviceLike = None,
                  doc_maxlen: Optional[int] = None) -> CascadeIndex:
    """Encode, pool at both factors, build the cascade. As the
    reference, each level runs its own ``Indexer.encode_and_pool``.
    ``doc_maxlen`` defaults to the model config's."""
    from repro_torch.core.spec import IndexSpec, PoolingSpec
    from repro_torch.retrieval.indexer import Indexer

    def level(factor):
        return Indexer(model, index_spec=IndexSpec(backend="flat"),
                       pooling_spec=PoolingSpec(pool_method, factor),
                       encode_batch=encode_batch, device=device
                       ).encode_and_pool(doc_tokens)

    coarse = level(coarse_factor)
    fine = level(fine_factor)
    idx = CascadeIndex(dim=model.cfg.proj_dim, coarse_factor=coarse_factor,
                       fine_factor=fine_factor, candidates=candidates,
                       doc_maxlen=doc_maxlen or model.cfg.doc_maxlen,
                       device=device)
    idx.add(coarse, fine)
    return idx
