"""Plain PyTorch versions of the MaxSim kernels (``csrc/maxsim.cu``).

Counterparts of ``src/repro/kernels/maxsim/ref.py``: einsum, mask, max
over doc tokens, masked sum over query tokens. The all-pairs version is
blocked over docs (as ``repro.core.maxsim.maxsim_scores_blocked``), so
its [Nq, block, Lq, Ld] intermediate stays bounded at corpus scale.

``maxsim_rerank_indexed_ref`` is the in-place rerank's plain version:
the store's candidates gathered, then ``maxsim_rerank_ref``.

``tf32_split_ref`` and ``einsum_3xtf32`` repeat the tensor-core kernels'
arithmetic (3xTF32) on the CPU; ``maxsim_3xtf32_ref`` and
``maxsim_rerank_3xtf32_ref`` are the all-pairs and rerank kernels'
twins, held against the JAX package by the tests and called on no path.
"""
from __future__ import annotations

from typing import Optional

import torch

_DOC_BLOCK = 256       # docs per all-pairs pass


def _reduce(sim, d_mask, q_mask):
    """sim [..., Lq, Ld] with d_mask broadcast to it -> masked MaxSim."""
    sim = sim.masked_fill(~d_mask, float("-inf"))
    best = sim.amax(dim=-1)                                  # [..., Lq]
    best = torch.where(q_mask & torch.isfinite(best), best,
                       torch.zeros((), device=best.device))
    return best.sum(dim=-1)


def maxsim_ref(q, q_mask, d, d_mask, block: Optional[int] = _DOC_BLOCK):
    """q [Nq, Lq, dim]; d [Nd, Ld, dim]; masks True = valid -> scores
    [Nq, Nd] f32 (0 for a doc with no valid token). ``block`` docs a
    pass; None scores every doc in one pass (the [Nq, Nd, Lq, Ld]
    similarities materialised, as the reference's ``maxsim_scores``)."""
    q = q.float()
    block = block or max(d.shape[0], 1)
    out = []
    for lo in range(0, d.shape[0], block):
        db = d[lo:lo + block].float()
        mb = d_mask[lo:lo + block]
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


def maxsim_rerank_indexed_ref(q, q_mask, d, d_mask, cand, cand_mask):
    """q [Nq, Lq, dim]; d [Nd, Ld, dim] and d_mask [Nd, Ld] (a store's
    padded view); cand / cand_mask [Nq, S] -> scores [Nq, S]: ``d[cand]``
    scored by ``maxsim_rerank_ref`` with ``d_mask[cand] & cand_mask``, so
    an invalid candidate scores 0 (its id, whatever it is, reads row 0)."""
    c = torch.where(cand_mask, cand, torch.zeros_like(cand)).long()
    return maxsim_rerank_ref(q, q_mask, d[c], d_mask[c] & cand_mask[..., None])


def tf32_split_ref(x, *, round_lo: bool = False):
    """x (f32, finite) -> (hi, lo) as the kernels' tensor cores read them:
    hi rounded to TF32 (10 mantissa bits, to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``), lo = x - hi truncated to TF32 (the tensor
    cores ignore an operand's low 13 bits; the all-pairs and k-means
    kernels) or, ``round_lo``, rounded as hi (``maxsim_packed``)."""
    def bits(v):
        return v.float().contiguous().view(torch.int32)
    hi = ((bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = bits(x.float() - hi)
    lo = ((lo + 0x1000) if round_lo else lo) & ~0x1FFF
    return hi, lo.view(torch.float32)


def einsum_3xtf32(eq, a, b, *, passes: int = 3, round_lo: bool = False):
    """``torch.einsum(eq, a, b)`` with the kernels' products: hi.hi +
    hi.lo + lo.hi of ``tf32_split_ref`` parts (``passes=1``: hi.hi
    alone, single-pass TF32), each product exact in f32."""
    ah, al = tf32_split_ref(a, round_lo=round_lo)
    bh, bl = tf32_split_ref(b, round_lo=round_lo)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    return out


def maxsim_3xtf32_ref(q, q_mask, d, d_mask, *, passes: int = 3):
    """``maxsim_ref`` with the all-pairs kernel's products (3xTF32)."""
    sim = einsum_3xtf32("qld,nkd->qnlk", q, d, passes=passes)
    return _reduce(sim, d_mask[None, :, None, :], q_mask[:, None, :])


def maxsim_rerank_3xtf32_ref(q, q_mask, d, d_mask, *, passes: int = 3):
    """``maxsim_rerank_ref`` with the rerank kernel's products (3xTF32)."""
    sim = einsum_3xtf32("qld,qskd->qslk", q, d, passes=passes)
    return _reduce(sim, d_mask[:, :, None, :], q_mask[:, None, :])
