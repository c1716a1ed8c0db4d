"""Plain PyTorch version of the Ward pooling kernel.

Counterpart of ``src/repro/kernels/ward_pool/ref.py``: the oracle is the
port's ``core/ward.py`` loop, which the CUDA kernel must match merge for
merge (same first-occurrence row-major tie-break). ``ward_agree`` is the
comparison that also holds on exact duplicate tokens, whose zero-distance
ties the two break along f32 summation orders of their own.
"""
from __future__ import annotations

import torch

from repro_torch.core.ward import normalize_masked, ward_cluster_batch


def ward_assign_ref(x, mask, factor: int):
    """[B, N, d] x [B, N] -> [B, N] int32 representative token ids."""
    return ward_cluster_batch(x, mask, factor)


def ward_objective(x, mask, assign):
    """[B] f64: each document's sum, over its valid tokens, of the squared
    distance from the token's unit vector to its cluster's mean."""
    u = normalize_masked(x, mask).double()         # masked rows are zero
    w = mask.double()
    idx = assign.long()
    sums = torch.zeros_like(u).scatter_add_(
        1, idx[..., None].expand_as(u), u)
    counts = torch.zeros_like(w).scatter_add_(1, idx, w)
    means = sums / counts.clamp(min=1.0)[..., None]
    r = u - means.gather(1, idx[..., None].expand_as(u))
    return ((r * r).sum(-1) * w).sum(-1)


def ward_agree(x, mask, got, want, atol: float = 1e-5):
    """[B] bool: per document, the two assignments are equal, or they hold
    the same number of clusters with Ward objectives within ``atol``."""
    own = torch.arange(got.shape[1], device=got.device)[None] == got
    own_want = torch.arange(want.shape[1], device=want.device)[None] == want
    same_k = (own & mask).sum(-1) == (own_want & mask).sum(-1)
    close = (ward_objective(x, mask, got)
             - ward_objective(x, mask, want)).abs() <= atol
    return (got == want).all(-1) | (same_k & close)
