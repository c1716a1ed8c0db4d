"""Plain PyTorch version of the compressed-domain rerank kernel.

Counterpart of ``src/repro/kernels/maxsim_packed/ref.py``: decode the
gathered packed rows (``quant.ref.decode_rows_ref``), then the masked
MaxSim of ``kernels/maxsim/ref.py`` ``maxsim_rerank_ref``.
"""
from __future__ import annotations

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
