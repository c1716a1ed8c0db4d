"""MaxSim scoring entry points and the top-k epilogue of every search.

Counterpart of ``src/repro/core/maxsim.py``: ``maxsim`` (one query
against one document, plain torch), ``maxsim_rerank`` (gathered
candidates, through the ``maxsim_rerank`` kernel), ``maxsim_scores`` (the
ColBERT search step's scoring, its queries and docs annotated as the
reference's; ``maxsim_scores_blocked`` the same), ``maxsim_all_docs``
(flat search and the dense corpus-wide fallback) and
``maxsim_rerank_store`` (candidates read from a ``DocStore``), both
through the ``maxsim`` kernels (``kernels/maxsim``), ``topk_docs``,
``topk_with_pads``, and ``topk_shard`` (a shard's top-k kept on the
device for the sharded merge).

``torch.topk`` does not order ties by lowest index; ``jax.lax.top_k``
does, and the candidate slates depend on it. ``stable_topk`` sorts
stably in descending order and slices, which does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.maxsim import ops as maxsim_ops
from repro_torch.sharding.api import constrain
from repro_torch.trace import count, span


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by lowest index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def topk_docs(scores: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores [Nq, Nd] -> (top scores [Nq, k], doc ids [Nq, k]), ties to
    the lowest id (``jax.lax.top_k``'s order)."""
    return stable_topk(scores, k)


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
    count("search.host_reads", 1)
    ids = ids.long().cpu().numpy()
    count("search.host_reads", 1)
    ids = np.where(np.isfinite(top_s), ids, -1)
    if kk < k:
        top_s = np.pad(top_s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
        ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
    return top_s.astype(np.float32), ids.astype(np.int64)


def topk_shard(scores: torch.Tensor, cand: Optional[torch.Tensor], k: int,
               base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's top-k, left on the device for the sharded merge.

    scores [Nq, C] (-inf marks invalid slots); cand [Nq, C] local doc
    ids, or None when the scores are shard-wide (ids = column index) ->
    (top scores [Nq, kk] f32, global ids [Nq, kk] int64), kk = min(k, C),
    ids shifted by ``base``. A slot whose score is -inf carries a
    meaningless id; the merge (``topk_with_pads``) maps it to -1. Ties
    go to the lowest position (``stable_topk``), so a shard's top-k
    then one merged top-k equals one top-k over all the slates."""
    kk = min(k, scores.shape[1])
    top_s, top_i = stable_topk(scores, kk)
    ids = top_i if cand is None else torch.gather(cand.long(), 1, top_i)
    return top_s.float(), ids.long() + int(base)


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


def maxsim(q, q_mask, d, d_mask) -> torch.Tensor:
    """q [Lq, dim]; d [Ld, dim] -> the scalar score
    sum_i max_j q_i . d_j over valid tokens (a query token with no valid
    doc token adds 0)."""
    sim = q @ d.T                                          # [Lq, Ld]
    sim = sim.masked_fill(~d_mask[None, :], float("-inf"))
    best = sim.amax(dim=-1)
    best = torch.where(q_mask & torch.isfinite(best), best,
                       torch.zeros((), dtype=best.dtype, device=best.device))
    return best.sum()


def maxsim_rerank(q, q_mask, d, d_mask, impl: str = "auto"):
    """Per-query scores of gathered candidates: q [Nq, Lq, dim]; d
    [Nq, S, Ld, dim], d_mask [Nq, S, Ld] -> [Nq, S] f32, query i scoring
    only d[i]: the ``maxsim_rerank`` kernel on the card, its plain
    version on CPU tensors."""
    return maxsim_ops.maxsim_rerank(q.float().contiguous(),
                                    q_mask.contiguous(),
                                    d.float().contiguous(),
                                    d_mask.contiguous(), impl=impl)


def maxsim_all_docs(q, q_mask, d, d_mask, impl: str = "auto"):
    """All-pairs scores [Nq, Nd]: the ``maxsim`` kernel on the card, its
    plain version (blocked over docs) on CPU tensors."""
    return maxsim_ops.maxsim(q.float().contiguous(), q_mask.contiguous(),
                             d, d_mask, impl=impl)


def maxsim_scores(q, q_mask, d, d_mask, block: Optional[int] = None):
    """All-pairs scores [Nq, Nd] of the ColBERT search step (the
    reference's ``maxsim_scores`` / ``maxsim_scores_blocked``): q and d
    annotated ``queries`` and ``docs``; the ``maxsim`` kernel on the
    card; on ``meta`` (the dry run's trace) the plain version, in one
    pass over all docs (``block`` None) or ``block`` docs a pass."""
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    q = constrain(q.float(), "queries", None, None)
    d = constrain(d.float(), "docs", None, None)
    if d.device.type == "meta":
        return maxsim_ref(q, q_mask, d, d_mask, block=block)
    return maxsim_all_docs(q, q_mask, d.contiguous(), d_mask.contiguous())


def maxsim_scores_blocked(q, q_mask, d, d_mask, block: int = 256):
    """The reference's memory-bounded variant: ``maxsim_scores`` with
    ``block`` docs a pass wherever the plain version runs (the kernel
    bounds its own memory)."""
    return maxsim_scores(q, q_mask, d, d_mask, block=block)


def maxsim_rerank_store(store, q, q_mask, cand, cand_mask, *,
                        slab: int = 1024, impl: str = "auto"):
    """Rerank candidates read from ``store`` (a ``DocStore``): the
    ``maxsim_rerank`` kernel reads each candidate's rows from the store's
    padded view in place, one launch for all of them; the plain version
    gathers them, slabbed over the candidate axis so the
    [Nq, slab, Ld, dim] gather stays bounded. cand/cand_mask [Nq, C]
    (device) -> scores [Nq, C] (-inf invalid)."""
    d, dm = store.padded()
    q, q_mask = q.float().contiguous(), q_mask.contiguous()
    plain = impl == "ref" or q.device.type != "cuda"
    width = slab if plain else max(cand.shape[1], 1)
    parts = []
    with span("search.maxsim_rerank"):
        for lo in range(0, cand.shape[1], width):
            c = cand[:, lo:lo + width]
            cm = cand_mask[:, lo:lo + width]
            s = maxsim_ops.maxsim_rerank_indexed(q, q_mask, d, dm, c, cm,
                                                 impl=impl)
            parts.append(s.masked_fill(~cm, float("-inf")))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
