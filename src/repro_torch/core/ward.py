"""Ward agglomerative clustering per document: the plain PyTorch version.

Counterpart of ``src/repro/core/ward.py`` ``ward_cluster`` (one document
to ``k_target`` clusters), ``ward_cluster_batch`` and the
plain twin of the ``ward_pool`` CUDA kernel. The state is a batched
[B, N, N] matrix of squared Ward linkage distances; each step merges the
first row-major minimum pair (i < j) of every document that still has
more than ``k`` clusters, with the Lance-Williams update

    D2(AB, C) = ((sA+sC) D2(A,C) + (sB+sC) D2(B,C) - sC D2(A,B))
                / max(sA+sB+sC, 1e-9)

Inputs are L2-normalized first (||a-b||^2 = 2(1-cos) for unit vectors,
so the merge order is the cosine one). Each document's target is
``k = n_valid // factor + 1``; the output maps each token to its
cluster's representative (lowest) token index.
"""
from __future__ import annotations

import torch

_INF = float("inf")


def normalize_masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32 unit rows, masked rows zero (what every Ward path clusters)."""
    x = x.float()
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                        min=1e-9)
    return torch.where(mask[..., None], x, torch.zeros((), device=x.device))


def ward_targets(mask: torch.Tensor, factor: int):
    """Per-doc cluster target k and merge budget max(n_valid - k, 0)."""
    n_valid = mask.sum(dim=-1).to(torch.int32)
    k = torch.clamp(n_valid // factor + 1, min=1).to(torch.int32)
    return k, torch.clamp(n_valid - k, min=0).to(torch.int32)


def ward_cluster(x: torch.Tensor, mask: torch.Tensor,
                 k_target: int) -> torch.Tensor:
    """One document: x [N, d], mask [N] bool -> assign [N] int32, merged
    down to ``max(k_target, 1)`` clusters (padded tokens keep their own
    index)."""
    n_valid = mask.sum().to(torch.int32)
    steps = torch.clamp(n_valid - max(int(k_target), 1), min=0)
    return _ward_merge(x[None], mask[None], steps[None])[0]


def ward_cluster_batch(x: torch.Tensor, mask: torch.Tensor,
                       factor: int) -> torch.Tensor:
    """x [B, N, d]; mask [B, N] bool -> assign [B, N] int32."""
    _, steps = ward_targets(mask, factor)
    return _ward_merge(x, mask, steps)


def _ward_merge(x: torch.Tensor, mask: torch.Tensor,
                steps: torch.Tensor) -> torch.Tensor:
    """The merge loop: document b merges ``steps[b]`` times (its valid
    tokens less its target k) -> assign [B, N] int32."""
    B, N, _ = x.shape
    dev = x.device
    x = normalize_masked(x, mask)
    sq = (x * x).sum(dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    d2 = torch.clamp(d2, min=0.0)
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    valid = mask[:, :, None] & mask[:, None, :] & ~eye
    d2 = d2.masked_fill(~valid, _INF)
    sizes = mask.float()
    assign = torch.arange(N, dtype=torch.int32, device=dev).repeat(B, 1)
    n_steps = int(steps.max()) if B else 0
    bidx = torch.arange(B, device=dev)
    lane = torch.arange(N, device=dev)[None, :]
    for step in range(n_steps):
        flat = torch.argmin(d2.reshape(B, -1), dim=1)      # first occurrence
        i, j = flat // N, flat % N
        i, j = torch.minimum(i, j), torch.maximum(i, j)
        dij = d2[bidx, i, j]
        do = (steps > step) & torch.isfinite(dij)           # n_active > k
        si, sj = sizes[bidx, i][:, None], sizes[bidx, j][:, None]
        sc = sizes
        d2i, d2j = d2[bidx, i], d2[bidx, j]                 # [B, N]
        new_row = ((si + sc) * d2i + (sj + sc) * d2j
                   - sc * dij[:, None]) / torch.clamp(si + sj + sc, min=1e-9)
        kill = (torch.isinf(d2i) | torch.isinf(d2j) | (lane == i[:, None])
                | (lane == j[:, None]))
        new_row = new_row.masked_fill(kill, _INF)
        row_i = torch.where(do[:, None], new_row, d2i)
        row_j = torch.where(do[:, None], torch.full_like(d2j, _INF), d2j)
        d2[bidx, i, :] = row_i
        d2[bidx, :, i] = row_i
        d2[bidx, j, :] = row_j
        d2[bidx, :, j] = row_j
        sizes = torch.where(
            do[:, None],
            torch.where(lane == i[:, None], si + sj,
                        torch.where(lane == j[:, None],
                                    torch.zeros((), device=dev), sizes)),
            sizes)
        assign = torch.where(do[:, None] & (assign == j[:, None].int()),
                             i[:, None].int(), assign)
    return assign
