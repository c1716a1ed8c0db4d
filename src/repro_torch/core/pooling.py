"""Token pooling — the paper's contribution — as an indexing-time step.

Counterpart of ``src/repro/core/pooling.py``: group each document's
token vectors with one of the paper's three methods and replace each
group by its renormalized mean.

  * ``sequential`` — runs of ``factor`` consecutive valid tokens;
  * ``kmeans``     — cosine k-means with n_valid // factor + 1 clusters
    (``core/kmeans.py``, through the ``kmeans_assign`` kernel);
  * ``ward``       — hierarchical Ward clustering (the ``ward_pool``
    kernel).

``pool_factor=1`` / ``none`` is the identity (the unpooled baseline).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.kmeans import kmeans_cluster_batch
from repro_torch.core.segment import batched_segment_sum
from repro_torch.core.spec import POOL_METHODS
from repro_torch.kernels.ward_pool.ops import ward_assign


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def sequential_assign(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """The g-th VALID token joins group ``g // factor``: mask [B, N] ->
    assign [B, N] int32. Grouping by valid-token rank means masked gaps
    do not split a run, so a doc with n valid tokens pools to exactly
    ``ceil(n / factor)`` vectors. Masked positions get an arbitrary
    (weight-zero) group id."""
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    return (torch.clamp(rank, min=0) // factor).to(torch.int32)


def _mean_pool_by_assign(x: torch.Tensor, mask: torch.Tensor,
                         assign: torch.Tensor, num_segments: int,
                         renormalize: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-mean x by assign per document: x [B, N, d], mask [B, N],
    assign [B, N] in [0, num_segments) -> (pooled [B, S, d],
    pooled_mask [B, S])."""
    B, N, d = x.shape
    sums, cnts = batched_segment_sum(x, assign, mask, num_segments)
    sums, cnts = sums.reshape(B * num_segments, d), cnts.reshape(-1)
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
    N = x.shape[1]
    if method == "ward":
        # assign ids live in [0, N) (representative token index)
        assign = ward_assign(x, mask, factor, impl=impl)
        return _mean_pool_by_assign(x, mask, assign, N, renormalize)
    if method == "sequential":
        assign = sequential_assign(mask, factor)
        nseg = (N + factor - 1) // factor
    else:
        assign = kmeans_cluster_batch(x, mask, factor, impl=impl)
        nseg = N // factor + 1
    pooled, pmask = _mean_pool_by_assign(x, mask, assign, nseg, renormalize)
    pad = N - nseg        # scatter into N slots, as the other methods do
    return (torch.nn.functional.pad(pooled, (0, 0, 0, pad)),
            torch.nn.functional.pad(pmask, (0, pad)))


def compact_pooled(pooled: torch.Tensor, pooled_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop empty slots on the device: -> (flat [sum(counts), d] rows
    doc-major in slot order, counts [B] int64). The boolean gather keeps
    the reference's order (``compact_pooled``'s validity sort)."""
    counts = pooled_mask.sum(dim=1)
    return pooled[pooled_mask], counts


def vector_counts(mask: torch.Tensor, pooled_mask: torch.Tensor):
    """(original vector count, pooled vector count) of a batch — the
    paper's Table 3."""
    return int(mask.sum()), int(pooled_mask.sum())
