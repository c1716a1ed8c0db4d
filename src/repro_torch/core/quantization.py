"""PLAID / ColBERTv2 residual quantization.

Counterpart of ``src/repro/core/quantization.py``. Every token vector is
stored as a centroid id plus a b-bit bucket code per dimension of the
residual ``v - c[id]``; bucket cutoffs are residual quantiles and bucket
values are per-bucket means. Codes are packed little-endian, 32 / b per
word. Words are ``torch.int32`` tensors carrying the uint32 bit pattern
(see ``kernels/quant/ref.py``).

The reference subsamples the codec's training residuals with
``jax.random.permutation``; here the subsample is an optional input
(``sample_idx``) and otherwise comes from a seeded ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.kmeans import nearest, random_rows
from repro_torch.core.segment import segment_sum
from repro_torch.kernels.quant.ref import decode_rows_ref, unpack_ref

_QUANTILE_MAX = 1 << 24     # torch.quantile refuses larger inputs
_ENCODE_CHUNK = 1 << 18     # rows per bucketize block


@dataclass
class ResidualCodec:
    centroids: torch.Tensor     # [K, dim] unit vectors
    cutoffs: torch.Tensor       # [dim, 2^b - 1] bucket boundaries
    values: torch.Tensor        # [dim, 2^b] reconstruction values
    bits: int

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[0]


def train_codec(vectors: torch.Tensor, centroids: torch.Tensor,
                bits: int = 2, sample: int = 65536, seed: int = 0,
                sample_idx: Optional[torch.Tensor] = None) -> ResidualCodec:
    """Fit bucket cutoffs / values from (a sample of) the residuals."""
    vectors = vectors.float()
    centroids = centroids.float()
    M = vectors.shape[0]
    if M > sample:
        if sample_idx is None:
            sample_idx = random_rows(M, sample, seed)
        vectors = vectors[torch.as_tensor(sample_idx,
                                          device=vectors.device).long()]
    res = vectors - centroids[nearest(vectors, centroids)]
    nb = 1 << bits
    qs = torch.arange(1, nb, dtype=torch.float32, device=res.device) / nb
    if res.numel() > _QUANTILE_MAX:
        raise ValueError(f"train_codec: {tuple(res.shape)} residuals exceed "
                         f"torch.quantile's {_QUANTILE_MAX} elements")
    cutoffs = torch.quantile(res, qs, dim=0).T.contiguous()   # [dim, nb-1]
    codes = _bucketize(res, cutoffs)
    dim = res.shape[1]
    seg = (codes + torch.arange(dim, device=res.device)[None, :] * nb)
    sums = segment_sum(res.reshape(-1), seg.reshape(-1), dim * nb)
    cnts = torch.bincount(seg.reshape(-1), minlength=dim * nb).float()
    values = (sums / torch.clamp(cnts, min=1.0)).reshape(dim, nb)
    return ResidualCodec(centroids=centroids, cutoffs=cutoffs,
                         values=values, bits=bits)


def _bucketize(res: torch.Tensor, cutoffs: torch.Tensor) -> torch.Tensor:
    """res [M, dim]; cutoffs [dim, nb-1] -> codes [M, dim] int64: the
    number of cutoffs strictly below each value."""
    return (res[:, :, None] > cutoffs[None, :, :]).sum(dim=-1)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes [M, dim] -> words [M, dim*bits/32] int32 (uint32 bits)."""
    M, dim = codes.shape
    cpw = 32 // bits
    if 32 % bits or dim % cpw:
        raise ValueError(f"pack_codes: dim {dim} is not a multiple of "
                         f"{cpw} codes per word at {bits} bits")
    c = codes.reshape(M, dim // cpw, cpw).long()
    shifts = torch.arange(cpw, device=codes.device) * bits
    words = (c << shifts).sum(dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_codes(words: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    return unpack_ref(words, bits, dim)


def encode(codec: ResidualCodec, vectors: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """vectors [M, dim] -> (centroid ids [M] int32, words [M, W] int32)."""
    vectors = vectors.float()
    ids, words = [], []
    for lo in range(0, vectors.shape[0], _ENCODE_CHUNK):
        v = vectors[lo:lo + _ENCODE_CHUNK]
        a = nearest(v, codec.centroids)
        codes = _bucketize(v - codec.centroids[a], codec.cutoffs)
        ids.append(a.to(torch.int32))
        words.append(pack_codes(codes, codec.bits))
    W = codec.dim * codec.bits // 32
    if not ids:
        return (torch.zeros(0, dtype=torch.int32, device=vectors.device),
                torch.zeros((0, W), dtype=torch.int32, device=vectors.device))
    return torch.cat(ids), torch.cat(words)


def decode(codec: ResidualCodec, assign: torch.Tensor,
           words: torch.Tensor) -> torch.Tensor:
    """-> reconstructed unit vectors [M, dim]."""
    return decode_rows_ref(words, assign, codec.centroids, codec.values,
                           codec.bits)
