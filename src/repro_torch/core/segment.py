"""Segment sums that give the same bits on every run, on the card too.

``index_add_`` on a CUDA tensor sums with atomics, in an order that
changes from run to run, so two builds of one corpus would not write the
same artifact bytes (pooled means, IVF centroids and codec values all
sum rows by segment). On the CPU both functions keep ``index_add_``,
which sums in row order; on the card they sum through one-hot products
(cuBLAS sums each product in one order, and row chunks add in row
order). The one-hot factors are exact, so the sums are f32 sums of the
same terms (with TF32 off, PyTorch's default for f32 products).

``sorted_segment_sum`` is the route for many segments (a graph's nodes,
where an [n, M] one-hot would cost n * M * f products): each segment's
rows are gathered through a padded CSR table and summed along it, in
row order, on every device; it keeps x's dtype and autograd (the
gather is ``F.embedding``, whose backward sums by sorting).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_ONEHOT_ELEMS = 1 << 26     # one-hot elements a chunk (256 MB of f32)


def _ordered(x: torch.Tensor, ordered: Optional[bool]) -> bool:
    return x.device.type == "cuda" if ordered is None else bool(ordered)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int,
                ordered: Optional[bool] = None) -> torch.Tensor:
    """x [M, ...] rows summed by segment id seg [M] in [0, n) ->
    [n, ...] f32. ``ordered`` picks the one-hot route (the default on a
    CUDA tensor) or ``index_add_``."""
    x = x.float()
    tail = tuple(x.shape[1:])
    if not _ordered(x, ordered):
        return torch.zeros((n,) + tail, device=x.device).index_add_(0, seg, x)
    rows = x.reshape(x.shape[0], math.prod(tail))
    out = torch.zeros((n, rows.shape[1]), device=x.device)
    ids = torch.arange(n, device=x.device)
    step = max(_ONEHOT_ELEMS // max(n, 1), 1)
    for lo in range(0, rows.shape[0], step):
        onehot = (seg[lo:lo + step, None] == ids[None, :]).float()
        out += onehot.T @ rows[lo:lo + step]
    return out.reshape((n,) + tail)


def batched_segment_sum(x: torch.Tensor, assign: torch.Tensor,
                        weight: torch.Tensor, n: int,
                        ordered: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document segment sums: x [B, N, d] rows times weight [B, N],
    summed by assign [B, N] in [0, n) -> (sums [B, n, d], weight sums
    [B, n]), f32. The one-hot route is one batched product."""
    B, N, d = x.shape
    x = x.float()
    w = weight.float()
    if not _ordered(x, ordered):
        seg = (torch.arange(B, device=x.device)[:, None] * n
               + assign.long()).reshape(-1)
        sums = torch.zeros(B * n, d, device=x.device).index_add_(
            0, seg, (x * w[..., None]).reshape(-1, d))
        cnts = torch.zeros(B * n, device=x.device).index_add_(
            0, seg, w.reshape(-1))
        return sums.reshape(B, n, d), cnts.reshape(B, n)
    onehot = (assign.long()[..., None] == torch.arange(
        n, device=x.device)).float() * w[..., None]            # [B, N, n]
    return torch.bmm(onehot.transpose(1, 2), x), onehot.sum(dim=1)


def sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       n: int) -> torch.Tensor:
    """x [M, f] rows summed by segment id seg [M] in [0, n) -> [n, f] in
    x's dtype: each segment's rows gathered through a padded CSR table
    ([n, max count] row ids in ascending order, the pad a zero row) and
    summed along it, the same order on every run and device. On
    ``meta`` tensors (the dry run: no data, so no table to size) the sum
    is an ``index_add_`` into [n, f], the same output and the reference's
    ``segment_sum``."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _sharded_segment_sum(x, seg, n)
    if x.device.type == "meta":
        return x.new_zeros((n, x.shape[1])).index_add_(0, seg, x)
    M = x.shape[0]
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=n)
    width = int(counts.max()) if M else 0
    first = torch.cumsum(counts, 0) - counts
    sorted_seg = seg[order]
    col = torch.arange(M, device=x.device) - first[sorted_seg]
    table = torch.full((n, max(width, 1)), M, dtype=torch.long,
                       device=x.device)
    table[sorted_seg, col] = order
    rows = torch.cat([x, x.new_zeros(1, x.shape[1])])
    return F.embedding(table, rows, padding_idx=M).sum(dim=1)


def _sharded_segment_sum(x, seg: torch.Tensor, n: int):
    """``sorted_segment_sum`` of rows laid out over a mesh: each rank sums
    its own rows into all n segments (the plain route on its shard), a
    partial sum over the mesh dims that split the rows, which the
    caller's layout reduces (a reduce-scatter onto a node shard)."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.sharding.api import from_local, lay_out
    mesh, place = x.device_mesh, x.placements
    if any(p.is_shard() and p.dim != 0 for p in place):
        raise ValueError(f"segment rows laid out {place}: only the row "
                         f"axis may be split")
    rows = [p if p.is_shard(0) else Replicate() for p in place]
    local = sorted_segment_sum(x.to_local(),
                               lay_out(seg, mesh, rows).to_local(), n)
    part = [Partial() if p.is_shard(0) else Replicate() for p in place]
    return from_local(local, mesh, part, (n, x.shape[1]),
                      grad_placements=[Replicate()] * mesh.ndim)
