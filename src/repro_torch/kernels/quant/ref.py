"""Plain PyTorch versions of the packed-code primitives.

Counterparts of ``src/repro/kernels/quant/ref.py`` ``unpack_ref`` and
``dequant_score_ref`` (pre-gathered centroid rows), and of the decode
half of ``kernels/maxsim_packed/ref.py``; ``dequant_score_ids_ref``
gathers the rows from centroid ids (the wrapper's plain version);
``dequant_score_3xtf32_ref`` repeats
the ``dequant_score`` kernel's products (3xTF32) on the CPU and is
called by the tests only. Packed words are
held as ``torch.int32`` tensors carrying the uint32 bit pattern: ``>>``
on ``torch.uint32`` is not implemented on the CPU, and masking the low
``bits`` after an arithmetic shift of the int32 view gives the same
codes. The CUDA side (``csrc/quant.cuh``) reads the same bytes as
``uint32_t``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.maxsim.ref import einsum_3xtf32


def unpack_ref(words: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """words [M, W] int32 (uint32 bits) -> codes [M, dim] int64
    (little-endian lanes, as ``pack_codes`` writes them)."""
    cpw = 32 // bits
    shifts = torch.arange(cpw, device=words.device, dtype=torch.int32) * bits
    c = (words[:, :, None] >> shifts[None, None, :]) & ((1 << bits) - 1)
    return c.reshape(words.shape[0], dim).long()


def _reconstruct(words: torch.Tensor, centroid_rows: torch.Tensor,
                 values: torch.Tensor, bits: int) -> torch.Tensor:
    """words [M, W], centroid_rows [M, dim] -> [M, dim] unit
    reconstructions: centroid row + per-dimension bucket value,
    renormalized by max(||v||, 1e-9)."""
    dim = centroid_rows.shape[1]
    codes = unpack_ref(words, bits, dim)                          # [M, dim]
    res = values[torch.arange(dim, device=words.device)[None, :], codes]
    v = centroid_rows + res
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def decode_rows_ref(words: torch.Tensor, ids: torch.Tensor,
                    centroids: torch.Tensor, values: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """words [M, W], ids [M] -> [M, dim] unit reconstructions: centroid
    row + per-dimension bucket value, renormalized by max(||v||, 1e-9)."""
    return _reconstruct(words, centroids[ids.long()], values, bits)


def dequant_score_ref(words: torch.Tensor, centroid_rows: torch.Tensor,
                      values: torch.Tensor, q: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """The reference's form: words [M, W], centroid_rows [M, dim] (the
    coarse centroids, gathered), values [dim, 2^bits], q [Lq, dim] ->
    sims [M, Lq] f32 of the unit-renormalized reconstructions."""
    v = _reconstruct(words, centroid_rows.float(), values.float(), bits)
    return v @ q.float().T


def dequant_score_ids_ref(words: torch.Tensor, centroid_ids: torch.Tensor,
                          centroids: torch.Tensor, values: torch.Tensor,
                          q: torch.Tensor, bits: int) -> torch.Tensor:
    """``dequant_score_ref`` with the centroid gather inside, the
    ``dequant_score`` wrapper's arguments (its plain version): words
    [M, W], centroid_ids [M] -> sims [M, Lq] f32."""
    v = decode_rows_ref(words, centroid_ids, centroids.float(),
                        values.float(), bits)
    return v @ q.float().T


def dequant_score_3xtf32_ref(words: torch.Tensor, centroid_ids: torch.Tensor,
                             centroids: torch.Tensor, values: torch.Tensor,
                             q: torch.Tensor, bits: int, *,
                             passes: int = 3) -> torch.Tensor:
    """``dequant_score_ref`` with the kernel's products: the
    reconstructions against q by hi.hi + hi.lo + lo.hi of TF32 parts
    (``passes=1``: hi.hi alone)."""
    v = decode_rows_ref(words, centroid_ids, centroids.float(),
                        values.float(), bits)
    return einsum_3xtf32("md,ld->ml", v, q.float(), passes=passes)
