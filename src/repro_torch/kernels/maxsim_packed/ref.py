"""Plain PyTorch version of the compressed-domain rerank kernel.

Counterpart of ``src/repro/kernels/maxsim_packed/ref.py``: decode the
gathered packed rows (``decode_rows_ref``, defined in ``quant/ref.py``
and exported here under the reference's path), then the masked MaxSim of
``kernels/maxsim/ref.py`` ``maxsim_rerank_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.maxsim.ref import einsum_3xtf32, maxsim_rerank_ref
from repro_torch.kernels.quant.ref import decode_rows_ref

__all__ = ["decode_rows_ref", "maxsim_packed_rerank_ref",
           "maxsim_packed_3xtf32_ref"]


def maxsim_packed_rerank_ref(q, q_mask, words, ids, d_mask, centroids,
                             values, *, bits: int):
    """q [Nq, Lq, dim]; words [Nq, S, Ld, W] int32; ids [Nq, S, Ld];
    d_mask [Nq, S, Ld] -> scores [Nq, S] f32. Masked slots decode to
    whatever their codes say and are forced to -inf before the max."""
    Nq, S, Ld, W = words.shape
    dim = centroids.shape[1]
    v = decode_rows_ref(words.reshape(-1, W), ids.reshape(-1), centroids,
                        values, bits)
    return maxsim_rerank_ref(q, q_mask, v.reshape(Nq, S, Ld, dim), d_mask)


SLAB = 128     # dims the kernel multiplies a step (csrc: SLAB)


def maxsim_packed_3xtf32_ref(q, q_mask, words, ids, d_mask, centroids,
                             values, *, bits: int, passes: int = 3):
    """``maxsim_packed_rerank_ref`` with the kernel's products: q . d as
    hi.hi + hi.lo + lo.hi of ``tf32_split_ref`` parts, lo rounded
    (``passes=1``: hi.hi alone, single-pass TF32), each product exact in
    f32, taken a slab of ``SLAB`` dims at a time and the slabs' partial
    sums added in order, as the kernel's K loop (one slab at dim <= 128)."""
    Nq, S, Ld, W = words.shape
    dim = centroids.shape[1]
    d = decode_rows_ref(words.reshape(-1, W), ids.reshape(-1), centroids,
                        values, bits).reshape(Nq, S * Ld, dim)
    sim = None
    for lo in range(0, dim, SLAB):
        part = einsum_3xtf32("qld,qtd->qlt", q[..., lo:lo + SLAB],
                             d[..., lo:lo + SLAB], passes=passes,
                             round_lo=True)
        sim = part if sim is None else sim + part
    sim = sim.reshape(Nq, -1, S, Ld).masked_fill(~d_mask[:, None],
                                                 float("-inf"))
    best = sim.amax(dim=-1)                                  # [Nq, Lq, S]
    best = torch.where(q_mask[:, :, None] & torch.isfinite(best), best,
                       torch.zeros((), device=best.device))
    return best.sum(dim=1)
