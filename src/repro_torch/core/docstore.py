"""Document store of per-doc token vectors, and CSR helpers for candidate
sets.

Counterpart of ``src/repro/core/docstore.py``. ``DocStore`` keeps one
flat ``[n_vectors, dim]`` f32 tensor on the index's device plus host CSR
``offsets`` and a ``live`` mask, and a cached padded
``[n_docs, L, dim]`` device view of tight width
``L = min(doc_maxlen, longest doc)`` that flat search and the f32 rerank
gather from. The view is built on the device by one ragged scatter (as
``PLAIDIndex.padded_packed``); nothing is re-padded per query.
``add`` appends (the view is rebuilt on the next read); ``delete`` is
lazy: the docs drop out of ``live`` and the view stays valid, since
liveness is a query-time mask.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated: counts [2, 0, 3] ->
    [0, 1, 0, 1, 2]."""
    counts = np.asarray(counts)
    total = int(counts.sum())
    return np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)


def padded_scatter_index(offsets: np.ndarray, L: int, device
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, cols, src) device indices that scatter the first
    min(len, L) rows of every CSR span into a padded [n_docs, L] view."""
    lens = np.diff(offsets)
    kept = np.minimum(lens, L)
    rows = np.repeat(np.arange(len(lens)), kept)
    cols = ragged_arange(kept)
    src = np.repeat(offsets[:-1], kept) + cols
    return tuple(torch.from_numpy(a).to(device) for a in (rows, cols, src))


class DocStore:
    def __init__(self, dim: int, doc_maxlen: int = 256,
                 device: DeviceLike = None):
        """An empty store on ``device`` (``resolve_device``: ``cuda``
        unless the caller names another). It grows to fit on each add:
        the reference's doubling reserve (``init_capacity``) would hold
        up to twice the store on the card."""
        self.dim = dim
        self.doc_maxlen = doc_maxlen
        self.device = resolve_device(device)
        self.flat = torch.zeros((0, dim), dtype=torch.float32,
                                device=self.device)
        self.offsets = np.zeros((1,), np.int64)
        self.live = np.zeros((0,), bool)
        self._padded: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @classmethod
    def from_arrays(cls, flat: torch.Tensor, offsets: np.ndarray,
                    live: np.ndarray, doc_maxlen: int = 256) -> "DocStore":
        """Adopt persisted arrays (``core/persist.py``): ``flat`` [M, dim]
        on its device; ``offsets``/``live`` copied to host numpy."""
        self = cls(int(flat.shape[1]), doc_maxlen, flat.device)
        self.flat = flat.float()
        self.offsets = np.array(offsets, np.int64)
        self.live = np.array(live, bool)
        return self

    # ------------------------------------------------------------- sizes
    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def n_vectors(self, live_only: bool = True) -> int:
        if not live_only:
            return int(self.offsets[-1])
        return int(self.doc_lengths()[self.live].sum())

    def nbytes(self, bytes_per_dim: int = 2, live_only: bool = True) -> int:
        """Footprint of the stored vectors (fp16 by default)."""
        return self.n_vectors(live_only) * self.dim * bytes_per_dim

    def _padded_len(self) -> int:
        lens = self.doc_lengths()
        return int(min(self.doc_maxlen, max(lens.max(initial=0), 1)))

    def device_nbytes(self) -> int:
        """Device bytes: the flat rows plus the padded view ([n, L, dim]
        f32 + [n, L] mask), from shapes, whether or not it is built."""
        n = self.n_docs
        if n == 0:
            return 0
        return (self.flat.numel() * 4
                + n * self._padded_len() * (self.dim * 4 + 1))

    # -------------------------------------------------------------- build
    def add(self, doc_vectors: Sequence[torch.Tensor]) -> np.ndarray:
        """Append docs (list of [n_i, dim]); returns their ids."""
        if len(doc_vectors) == 0:
            return np.arange(self.n_docs, self.n_docs)
        flat = torch.cat([torch.as_tensor(v).reshape(-1, self.dim)
                          .to(self.device, torch.float32)
                          for v in doc_vectors])
        return self.add_flat(flat, [len(v) for v in doc_vectors])

    def add_flat(self, flat: torch.Tensor, lens) -> np.ndarray:
        """Append docs given as doc-major rows [sum(lens), dim] and
        per-doc counts; returns their ids."""
        lens = np.asarray(lens, np.int64)
        ids = np.arange(self.n_docs, self.n_docs + len(lens))
        self.flat = torch.cat([self.flat,
                               flat.to(self.device, torch.float32)])
        self.offsets = np.concatenate(
            [self.offsets, self.offsets[-1] + np.cumsum(lens)])
        self.live = np.concatenate([self.live, np.ones(len(lens), bool)])
        self._padded = None
        return ids

    def delete(self, doc_ids) -> None:
        """Lazy delete: the docs stay in storage, out of ``live``."""
        self.live[np.asarray(doc_ids, np.int64)] = False

    # ------------------------------------------------------------- reads
    def doc(self, i: int) -> torch.Tensor:
        """Doc i's rows [n_i, dim] (a view on the device)."""
        return self.flat[self.offsets[i]:self.offsets[i + 1]]

    def docs_list(self) -> List[torch.Tensor]:
        """Per-doc rows, deleted docs included."""
        return [self.doc(i) for i in range(self.n_docs)]

    def padded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cached device view ([max(n, 1), L, dim] f32, [max(n, 1), L]
        bool); dead docs keep their rows (liveness is a query-time
        mask)."""
        if self._padded is None:
            n, L = self.n_docs, self._padded_len()
            out = torch.zeros((max(n, 1), L, self.dim), dtype=torch.float32,
                              device=self.device)
            mask = torch.zeros((max(n, 1), L), dtype=torch.bool,
                               device=self.device)
            if n and len(self.flat):
                r, c, s = padded_scatter_index(self.offsets, L, self.device)
                out[r, c] = self.flat[s]
                mask[r, c] = True
            self._padded = (out, mask)
        return self._padded

    def gather(self, cand: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cand [Nq, C] doc ids (device) -> ([Nq, C, L, dim],
        [Nq, C, L])."""
        d, m = self.padded()
        return d[cand], m[cand]


def pad_candidate_sets(qidx: np.ndarray, docs: np.ndarray, n_queries: int,
                       block: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """(query, doc) id pairs grouped by query -> (cand [Nq, C], mask
    [Nq, C]); C is the geometric width block << m covering the largest
    per-query count."""
    counts = np.bincount(qidx, minlength=n_queries)
    C = max(int(counts.max(initial=0)), 1)
    C = block << max(int(np.ceil(np.log2(-(-C // block)))), 0)
    cand = np.zeros((n_queries, C), np.int64)
    mask = np.arange(C)[None, :] < counts[:, None]
    cand[qidx, ragged_arange(counts)] = docs
    return cand, mask
