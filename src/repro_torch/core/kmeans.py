"""Lloyd k-means on cosine similarity: per-document k-means pooling (the
paper's second pooling method) and the IVF centroid trainer.

Counterpart of ``src/repro/core/kmeans.py``.

Per-document k-means (``kmeans_cluster_batch``): the reference's
``vmap`` over documents is a batch dimension here. Each document gets
K = n_valid // factor + 1 clusters, padded to k_max = N // factor + 1
and masked; strided initial centroids over the valid tokens, 10 Lloyd
steps, then a final assignment. Every assignment goes through the
``kmeans_assign`` kernel, one launch per step for the whole batch. The
centroid update is a one-hot ``bmm`` (a plain product, as the reference
computes it outside any kernel) rather than ``index_add_``, whose CUDA
atomics sum in an order that changes from run to run and would let later
assignments flip.

IVF training (``kmeans_train``): the reference seeds its centroids with
``jax.random.permutation(PRNGKey(0), M)[:k]``; torch generators cannot
reproduce that permutation, so the initial rows are an optional input
(``init_idx``) — the parity tests pass the reference's — and otherwise
come from a seeded ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.segment import segment_sum
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign

_CHUNK = 1 << 20        # rows per similarity block: bounds [chunk, k]


def normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def nearest(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """First argmax of x @ c^T per row -> [M] int64 (row blocks)."""
    return torch.cat([torch.argmax(x[lo:lo + _CHUNK] @ c.T, dim=-1)
                      for lo in range(0, x.shape[0], _CHUNK)]) \
        if x.shape[0] else torch.zeros(0, dtype=torch.long, device=x.device)


def random_rows(M: int, k: int, seed: int) -> torch.Tensor:
    """k distinct row indices drawn from a CPU generator seeded ``seed``."""
    return torch.randperm(M, generator=torch.Generator().manual_seed(seed))[:k]


def kmeans_train(x: torch.Tensor, k: int, n_iters: int = 12, *,
                 init_idx: Optional[torch.Tensor] = None,
                 seed: int = 0) -> torch.Tensor:
    """x [M, d] -> unit centroids [k, d]; empty clusters keep their
    previous centroid."""
    x = normalize(x.float())
    M = x.shape[0]
    if init_idx is None:
        init_idx = random_rows(M, k, seed)
    c = x[torch.as_tensor(init_idx, device=x.device).long()]
    for _ in range(n_iters):
        a = nearest(x, c)
        sums = segment_sum(x, a, k)
        cnts = torch.bincount(a, minlength=k).to(x.dtype)
        new = normalize(sums / torch.clamp(cnts[:, None], min=1e-9))
        c = torch.where((cnts > 0)[:, None], new, c)
    return c


# ---------------------------------------------------------------------------
# Per-document k-means (pooling method "kmeans")
# ---------------------------------------------------------------------------
def _init_centroids(x: torch.Tensor, mask: torch.Tensor,
                    k_max: int) -> torch.Tensor:
    """Strided init: ~evenly spaced valid tokens. x [B, N, d], mask
    [B, N] -> [B, k_max, d]."""
    B, N, d = x.shape
    n_valid = torch.clamp(mask.sum(dim=-1), min=1)                # [B]
    # positions of the valid tokens first, in order
    idx_sorted = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    stride_pos = (torch.arange(k_max, device=x.device)[None, :]
                  * n_valid[:, None]) // k_max                    # [B, k_max]
    take = torch.gather(idx_sorted, 1, torch.clamp(stride_pos, 0, N - 1))
    return torch.gather(x, 1, take[..., None].expand(B, k_max, d))


def kmeans_assign_step(x: torch.Tensor, centroids: torch.Tensor,
                       mask: torch.Tensor, k_mask: torch.Tensor,
                       impl: str = "auto") -> torch.Tensor:
    """One assignment through the kernel: x [B, N, d], centroids
    [B, K, d] (unit), k_mask [B, K] -> assign [B, N] int32 (0 where
    ``mask`` is False)."""
    assign, _ = kmeans_assign(x, centroids, k_mask, impl=impl)
    return torch.where(mask, assign, torch.zeros_like(assign))


def _update_centroids(x: torch.Tensor, assign: torch.Tensor,
                      mask: torch.Tensor, centroids: torch.Tensor,
                      k_mask: torch.Tensor) -> torch.Tensor:
    """Segment means by a one-hot product (deterministic on the card);
    empty or masked clusters keep their old centroid."""
    K = centroids.shape[1]
    onehot = ((assign[:, None, :] == torch.arange(
        K, device=x.device, dtype=assign.dtype)[None, :, None])
        & mask[:, None, :]).to(x.dtype)                          # [B, K, N]
    sums = torch.bmm(onehot, x)
    cnts = onehot.sum(dim=-1)
    new = normalize(sums / torch.clamp(cnts[..., None], min=1e-9))
    keep = (cnts > 0) & k_mask
    return torch.where(keep[..., None], new, centroids)


def kmeans_fit_batch(x: torch.Tensor, mask: torch.Tensor,
                     k_target: torch.Tensor, k_max: int, n_iters: int = 10,
                     impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Lloyd loop of ``kmeans_cluster`` for a batch of documents:
    x [B, N, d], mask [B, N], k_target [B] -> (unit masked x [B, N, d],
    centroids after the last step [B, k_max, d], k_mask [B, k_max])."""
    x = normalize(x.float())
    x = torch.where(mask[..., None], x, torch.zeros((), device=x.device))
    k_mask = (torch.arange(k_max, device=x.device)[None, :]
              < torch.clamp(k_target, min=1)[:, None])
    c = normalize(_init_centroids(x, mask, k_max))
    for _ in range(n_iters):
        a = kmeans_assign_step(x, c, mask, k_mask, impl)
        c = _update_centroids(x, a, mask, c, k_mask)
    return x, c, k_mask


def kmeans_cluster(x: torch.Tensor, mask: torch.Tensor, k_target: int,
                   k_max: int, n_iters: int = 10,
                   impl: str = "auto") -> torch.Tensor:
    """Cluster one document: x [N, d], mask [N] -> assign [N] int32 in
    [0, k_max)."""
    k = torch.as_tensor([k_target], device=x.device)
    xn, c, k_mask = kmeans_fit_batch(x[None], mask[None], k, k_max,
                                     n_iters, impl)
    return kmeans_assign_step(xn, c, mask[None], k_mask, impl)[0]


def kmeans_cluster_batch(x: torch.Tensor, mask: torch.Tensor, factor: int,
                         n_iters: int = 10,
                         impl: str = "auto") -> torch.Tensor:
    """x [B, N, d], mask [B, N] -> assign [B, N] int32, cluster ids below
    k_max = N // factor + 1 (each document's below n_valid // factor + 1).
    Launches the assignment kernel n_iters + 1 times."""
    k_max = x.shape[1] // factor + 1
    k_target = mask.sum(dim=-1) // factor + 1
    xn, c, k_mask = kmeans_fit_batch(x, mask, k_target, k_max, n_iters,
                                     impl)
    return kmeans_assign_step(xn, c, mask, k_mask, impl)
