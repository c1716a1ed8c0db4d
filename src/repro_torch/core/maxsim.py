"""Top-k epilogue of every search (``src/repro/core/maxsim.py``
``topk_with_pads``) on a stable top-k.

``torch.topk`` does not order ties by lowest index; ``jax.lax.top_k``
does, and the candidate slates depend on it. ``stable_topk`` sorts
stably in descending order and slices, which does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by lowest index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def topk_with_pads(scores: torch.Tensor, cand: Optional[torch.Tensor],
                   k: int) -> Tuple[np.ndarray, np.ndarray]:
    """scores [Nq, C] (-inf marks invalid slots); cand [Nq, C] doc ids
    (None: ids are the column index) -> host (scores [Nq, k] f32,
    ids [Nq, k] i64), padded with -inf / -1. The only device-to-host
    transfer of a search is this [Nq, k] result."""
    kk = min(k, scores.shape[1])
    top_s, top_i = stable_topk(scores, kk)
    ids = top_i if cand is None else torch.gather(cand, 1, top_i)
    top_s = top_s.float().cpu().numpy()
    ids = ids.long().cpu().numpy()
    ids = np.where(np.isfinite(top_s), ids, -1)
    if kk < k:
        top_s = np.pad(top_s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
        ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
    return top_s.astype(np.float32), ids.astype(np.int64)


def tie_aware_mismatches(I0: np.ndarray, S0: np.ndarray, I1: np.ndarray,
                         S1: np.ndarray, tol: float) -> int:
    """Rank slots where two top-k lists (ids I, scores S, [Nq, k])
    disagree beyond a tie: ids may differ at a rank only where both
    scores agree within ``tol`` and the displaced id sits in the other
    list (or just off its end) at a score within ``tol``."""
    bad = 0
    for r in range(I0.shape[0]):
        for j in range(I0.shape[1]):
            if I0[r, j] == I1[r, j]:
                continue
            where = np.nonzero(I1[r] == I0[r, j])[0]
            other = S1[r, where[0]] if len(where) else S1[r, -1]
            bad += int(abs(S0[r, j] - S1[r, j]) > tol
                       or abs(other - S0[r, j]) > tol)
    return bad
