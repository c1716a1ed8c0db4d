"""CSR helpers for candidate sets (``src/repro/core/docstore.py``
``ragged_arange`` and ``pad_candidate_sets``), numpy on the host."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated: counts [2, 0, 3] ->
    [0, 1, 0, 1, 2]."""
    counts = np.asarray(counts)
    total = int(counts.sum())
    return np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)


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
