"""Lloyd k-means on cosine similarity: the IVF centroid trainer.

Counterpart of ``src/repro/core/kmeans.py`` ``kmeans_train``. The
reference seeds its centroids with ``jax.random.permutation(PRNGKey(0),
M)[:k]``; torch generators cannot reproduce that permutation, so the
initial rows are an optional input (``init_idx``) — the parity tests
pass the reference's — and otherwise come from a seeded
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch

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
        sums = torch.zeros_like(c).index_add_(0, a, x)
        cnts = torch.bincount(a, minlength=k).to(x.dtype)
        new = normalize(sums / torch.clamp(cnts[:, None], min=1e-9))
        c = torch.where((cnts > 0)[:, None], new, c)
    return c
