"""Token pooling — the paper's contribution — as an indexing-time step.

Counterpart of ``src/repro/core/pooling.py`` for methods ``none`` and
``ward``: cluster each document's token vectors (Ward, through the
``ward_pool`` kernel) and replace each cluster by its renormalized mean.
``pool_factor=1`` / ``none`` is the identity (the unpooled baseline).
``sequential`` and ``kmeans`` pooling are queued in ROADMAP queue 1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.spec import PORTED_POOL_METHODS, POOL_METHODS
from repro_torch.kernels.ward_pool.ops import ward_assign


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def _mean_pool_by_assign(x: torch.Tensor, mask: torch.Tensor,
                         assign: torch.Tensor, num_segments: int,
                         renormalize: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-mean x by assign per document: x [B, N, d], mask [B, N],
    assign [B, N] in [0, num_segments) -> (pooled [B, S, d],
    pooled_mask [B, S])."""
    B, N, d = x.shape
    w = mask.float()
    seg = (torch.arange(B, device=x.device)[:, None] * num_segments
           + assign.long()).reshape(-1)
    sums = torch.zeros(B * num_segments, d, device=x.device).index_add_(
        0, seg, (x.float() * w[..., None]).reshape(-1, d))
    cnts = torch.zeros(B * num_segments, device=x.device).index_add_(
        0, seg, w.reshape(-1))
    mean = sums / torch.clamp(cnts[:, None], min=1e-9)
    if renormalize:
        mean = _normalize(mean)
    live = cnts > 0
    mean = mean * live[:, None]
    return mean.reshape(B, num_segments, d), live.reshape(B, num_segments)


def pool_doc_embeddings(x: torch.Tensor, mask: torch.Tensor, factor: int,
                        method: str = "ward", renormalize: bool = True,
                        impl: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, d] token embeddings, mask [B, N] -> (pooled [B, N, d]
    scattered into slots (zero rows where no cluster lives),
    pooled_mask [B, N])."""
    if method not in POOL_METHODS:
        raise ValueError(f"unknown pooling method {method!r}")
    if method == "none" or factor <= 1:
        xo = x.float()
        if renormalize:
            xo = _normalize(xo)
        return torch.where(mask[..., None], xo,
                           torch.zeros((), device=x.device)), mask
    if method not in PORTED_POOL_METHODS:
        raise NotImplementedError(
            f"pooling method {method!r} is not ported yet (ROADMAP queue 1: "
            f"sequential and k-means pooling with kmeans_assign)")
    assign = ward_assign(x, mask, factor, impl=impl)
    return _mean_pool_by_assign(x, mask, assign, x.shape[1], renormalize)


def compact_pooled(pooled: torch.Tensor, pooled_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop empty slots on the device: -> (flat [sum(counts), d] rows
    doc-major in slot order, counts [B] int64). The boolean gather keeps
    the reference's order (``compact_pooled``'s validity sort)."""
    counts = pooled_mask.sum(dim=1)
    return pooled[pooled_mask], counts
