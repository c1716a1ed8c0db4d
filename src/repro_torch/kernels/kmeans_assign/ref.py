"""Plain PyTorch version of the k-means assignment kernel.

Counterpart of ``src/repro/kernels/kmeans_assign/ref.py``: x . c^T in
f32, masked clusters at -inf, max and first argmax per row (the smallest
index among equal maxima, so a row whose clusters are all masked gets 0
and -inf). Batched over a leading document axis.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.maxsim.ref import einsum_3xtf32


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor,
                      k_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, dim]; centroids [B, K, dim]; k_mask [B, K] bool ->
    (assign [B, N] int32, best [B, N] f32)."""
    sim = torch.bmm(x.float(), centroids.float().transpose(1, 2))
    return _first_argmax(sim, k_mask)


def kmeans_assign_3xtf32_ref(x, centroids, k_mask, *, passes: int = 3):
    """``kmeans_assign_ref`` with the kernel's products: 3xTF32 parts of
    x and the centroids (``passes=1``: single-pass TF32). Called on no
    path; the tests hold it to the JAX package."""
    sim = einsum_3xtf32("bnd,bkd->bnk", x.float(), centroids.float(),
                        passes=passes)
    return _first_argmax(sim, k_mask)


def _first_argmax(sim, k_mask):
    """sim [B, N, K] -> (first argmax over unmasked k, max)."""
    sim = sim.masked_fill(~k_mask[:, None, :], float("-inf"))
    best = sim.amax(dim=-1)
    K = sim.shape[-1]
    iota = torch.arange(K, device=sim.device, dtype=torch.int32)
    idx = torch.where(sim == best[..., None], iota,
                      torch.full((), K, dtype=torch.int32,
                                 device=sim.device)).amin(dim=-1)
    return torch.where(idx >= K, torch.zeros_like(idx), idx), best
