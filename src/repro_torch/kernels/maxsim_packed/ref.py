"""Plain PyTorch version of the compressed-domain rerank kernel.

Counterpart of ``src/repro/kernels/maxsim_packed/ref.py``: decode the
gathered packed rows (``quant.ref.decode_rows_ref``), then the masked
MaxSim of ``kernels/maxsim/ref.py`` ``maxsim_rerank_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.maxsim.ref import maxsim_rerank_ref
from repro_torch.kernels.quant.ref import decode_rows_ref


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


def tf32_split_ref(x):
    """x (f32) -> (hi, lo): hi rounded to TF32 (10 mantissa bits, to
    nearest, ties away from zero: ``cvt.rna.tf32.f32``), lo the rest
    rounded the same way, as the kernel splits its operands."""
    def rna(v):
        b = v.float().contiguous().view(torch.int32)
        return ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x.float() - hi)


def maxsim_packed_3xtf32_ref(q, q_mask, words, ids, d_mask, centroids,
                             values, *, bits: int, passes: int = 3):
    """``maxsim_packed_rerank_ref`` with the kernel's products: q . d as
    hi.hi + hi.lo + lo.hi of ``tf32_split_ref`` parts (``passes=1``: hi.hi
    alone, single-pass TF32), each product exact in f32."""
    Nq, S, Ld, W = words.shape
    dim = centroids.shape[1]
    d = decode_rows_ref(words.reshape(-1, W), ids.reshape(-1), centroids,
                        values, bits).reshape(Nq, S * Ld, dim)
    qh, ql = tf32_split_ref(q)
    dh, dl = tf32_split_ref(d)
    sim = torch.einsum("qld,qtd->qlt", qh, dh)
    if passes == 3:
        sim = (sim + torch.einsum("qld,qtd->qlt", qh, dl)
               + torch.einsum("qld,qtd->qlt", ql, dh))
    sim = sim.reshape(Nq, -1, S, Ld).masked_fill(~d_mask[:, None],
                                                 float("-inf"))
    best = sim.amax(dim=-1)                                  # [Nq, Lq, S]
    best = torch.where(q_mask[:, :, None] & torch.isfinite(best), best,
                       torch.zeros((), device=best.device))
    return best.sum(dim=1)
