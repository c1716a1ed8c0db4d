"""Plain PyTorch versions of the MaxSim kernels (``csrc/maxsim.cu``).

Counterparts of ``src/repro/kernels/maxsim/ref.py``: einsum, mask, max
over doc tokens, masked sum over query tokens. The all-pairs version is
blocked over docs (as ``repro.core.maxsim.maxsim_scores_blocked``), so
its [Nq, block, Lq, Ld] intermediate stays bounded at corpus scale.
"""
from __future__ import annotations

import torch

_DOC_BLOCK = 256       # docs per all-pairs pass


def _reduce(sim, d_mask, q_mask):
    """sim [..., Lq, Ld] with d_mask broadcast to it -> masked MaxSim."""
    sim = sim.masked_fill(~d_mask, float("-inf"))
    best = sim.amax(dim=-1)                                  # [..., Lq]
    best = torch.where(q_mask & torch.isfinite(best), best,
                       torch.zeros((), device=best.device))
    return best.sum(dim=-1)


def maxsim_ref(q, q_mask, d, d_mask):
    """q [Nq, Lq, dim]; d [Nd, Ld, dim]; masks True = valid -> scores
    [Nq, Nd] f32 (0 for a doc with no valid token)."""
    q = q.float()
    out = []
    for lo in range(0, d.shape[0], _DOC_BLOCK):
        db = d[lo:lo + _DOC_BLOCK].float()
        mb = d_mask[lo:lo + _DOC_BLOCK]
        sim = torch.einsum("qld,nkd->qnlk", q, db)
        out.append(_reduce(sim, mb[None, :, None, :], q_mask[:, None, :]))
    if not out:
        return q.new_zeros((q.shape[0], 0))
    return torch.cat(out, dim=1)


def maxsim_rerank_ref(q, q_mask, d, d_mask):
    """q [Nq, Lq, dim]; d [Nq, S, Ld, dim]; masks True = valid
    -> scores [Nq, S] f32 (each query scores only its own docs)."""
    sim = torch.einsum("qld,qskd->qslk", q.float(), d.float())
    return _reduce(sim, d_mask[:, :, None, :], q_mask[:, None, :])
