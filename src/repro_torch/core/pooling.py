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

A pooled batch is compacted on the device by a validity sort that moves
the valid rows doc-major to the front (``compact_pooled_begin``), so
only ``sum(counts)`` rows and the counts leave the card
(``compact_pooled_finish``; ``compaction_transfer_stats`` sums the
bytes). ``begin`` queues the work and the counts' copy without waiting,
so the indexer finishes batch i while batch i+1 runs.
``compact_pooled`` returns the reference's per-doc numpy list;
``compact_pooled_flat`` keeps the rows on the device with the counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kmeans import kmeans_cluster_batch
from repro_torch.core.segment import batched_segment_sum
from repro_torch.core.spec import BUILTIN_POOL_METHODS, POOL_METHODS
from repro_torch.kernels.ward_pool import ops as ward_ops

METHODS = BUILTIN_POOL_METHODS        # the reference's name


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
                        ward_kernel: str = "auto", impl: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, d] token embeddings, mask [B, N] -> (pooled [B, N, d]
    scattered into slots (zero rows where no cluster lives),
    pooled_mask [B, N]). ``ward_kernel`` is the reference's: Ward's
    implementation, one of ``WARD_IMPLS``. ``impl="ref"`` runs every
    method's kernel as its plain version (Ward's and k-means'); either
    one at ``"ref"`` gives the plain Ward."""
    if ward_kernel not in ward_ops.WARD_IMPLS:
        raise ValueError(f"ward_kernel must be one of {ward_ops.WARD_IMPLS}, "
                         f"got {ward_kernel!r}")
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
        ward_impl = "ref" if "ref" in (impl, ward_kernel) else ward_kernel
        assign = ward_ops.ward_assign(x, mask, factor, impl=ward_impl)
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


# device-to-host compaction traffic, summed over finished tickets:
# padded = the [B, N, d] tensor a gather on the host would pull,
# compact = what crossed (rows and counts from compact_pooled_finish,
# the counts alone where the rows stay on the device)
_TRANSFER_STATS = {"padded_bytes": 0, "compact_bytes": 0, "batches": 0}


def compaction_transfer_stats(reset: bool = False) -> dict:
    """The summed compaction traffic (``benchmarks/index_bench.py``'s
    ``<= 1/factor + eps`` gate reads the reference's); ``reset`` zeroes
    it after the read."""
    out = dict(_TRANSFER_STATS)
    if reset:
        for k in _TRANSFER_STATS:
            _TRANSFER_STATS[k] = 0
    return out


@dataclass
class CompactionTicket:
    """What ``compact_pooled_begin`` queued: every slot's row, valid rows
    first in doc-major slot order; the per-doc counts on the device and
    their copy in pinned host memory, ready once ``event`` has fired
    (None on the CPU, where the copy is done)."""
    rows: torch.Tensor            # [B*N, d]
    counts: torch.Tensor          # [B] int32, on the rows' device
    host_counts: torch.Tensor     # [B] int32, on the host
    shape: Tuple[int, int, int]
    dtype: torch.dtype
    event: Optional["torch.cuda.Event"] = None

    def wait_counts(self) -> np.ndarray:
        """The per-doc counts on the host, waiting on the copy's event
        alone, not on the device."""
        if self.event is not None:
            self.event.synchronize()
        return self.host_counts.numpy()

    def device_rows(self) -> Tuple[torch.Tensor, np.ndarray]:
        """(the sum(counts) valid rows [M, d] on the device, counts [B])
        — the ticket finished without moving a row: only the counts
        crossed, and only they are added to the compact bytes."""
        counts = self.wait_counts()
        self.account(counts.nbytes)
        return self.rows[:int(counts.sum())], counts

    def account(self, moved: int) -> None:
        """Add this batch to ``_TRANSFER_STATS``: its padded [B, N, d]
        bytes, and ``moved`` bytes that crossed to the host."""
        B, N, d = self.shape
        _TRANSFER_STATS["padded_bytes"] += (
            B * N * d * torch.empty((), dtype=self.dtype).element_size())
        _TRANSFER_STATS["compact_bytes"] += moved
        _TRANSFER_STATS["batches"] += 1


def compact_pooled_begin(pooled: torch.Tensor, pooled_mask: torch.Tensor
                         ) -> CompactionTicket:
    """Queue the compaction of a pooled batch without waiting on the
    device: the reference's validity sort (key ``idx`` for a valid slot,
    ``idx + B*N`` for an empty one: distinct keys, so the order is the
    boolean gather's), the rows gathered in that order, the counts, and
    the counts' copy to pinned host memory. Finish it with
    ``compact_pooled_finish`` (rows to the host) or
    ``CompactionTicket.device_rows`` (rows kept on the device); a caller
    overlaps the wait with the next batch's work."""
    B, N, d = pooled.shape
    flat_mask = pooled_mask.reshape(-1)
    idx = torch.arange(B * N, device=pooled.device)
    order = torch.argsort(torch.where(flat_mask, idx, idx + B * N))
    rows = pooled.reshape(B * N, d)[order]
    counts = pooled_mask.sum(dim=1, dtype=torch.int32)
    if counts.device.type != "cuda":
        return CompactionTicket(rows, counts, counts.cpu(), (B, N, d),
                                pooled.dtype)
    host = torch.empty(B, dtype=torch.int32, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return CompactionTicket(rows, counts, host, (B, N, d), pooled.dtype,
                            event)


def compact_pooled_finish(ticket: CompactionTicket) -> List[np.ndarray]:
    """The ticket's documents on the host: only the sum(counts) valid
    rows and the [B] counts cross. -> per-doc [n_i, d] numpy arrays
    (``np.split`` views), the reference's list."""
    counts = ticket.wait_counts()
    host = ticket.rows[:int(counts.sum())].cpu().numpy()
    ticket.account(host.nbytes + counts.nbytes)
    return np.split(host, np.cumsum(counts[:-1]))


def compact_pooled_flat(pooled: torch.Tensor, pooled_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop empty slots on the device: -> (flat [sum(counts), d] rows
    doc-major in slot order, counts [B] int64), through the validity
    sort of ``compact_pooled_begin``: the host waits for the counts'
    copy alone (a boolean gather waits for the device to size its
    output)."""
    ticket = compact_pooled_begin(pooled, pooled_mask)
    rows, _ = ticket.device_rows()
    return rows, ticket.counts.long()


def compact_pooled(pooled, pooled_mask) -> List[np.ndarray]:
    """Drop empty slots -> the reference's list of per-doc [n_i, d]
    numpy arrays (``[]`` for an empty batch). Tensors go through
    ``compact_pooled_begin`` / ``compact_pooled_finish`` (only the valid
    rows and the counts leave the card); numpy inputs take the boolean
    gather. Both give the same arrays, ``np.split`` views on the
    cumulative counts."""
    if pooled.shape[0] == 0:
        return []
    if torch.is_tensor(pooled) and torch.is_tensor(pooled_mask):
        return compact_pooled_finish(compact_pooled_begin(pooled,
                                                          pooled_mask))
    pooled = np.asarray(pooled)
    pooled_mask = np.asarray(pooled_mask).astype(bool)
    counts = pooled_mask.sum(axis=1)
    return np.split(pooled[pooled_mask], np.cumsum(counts[:-1]))


def vector_counts(mask: torch.Tensor, pooled_mask: torch.Tensor):
    """(original vector count, pooled vector count) of a batch — the
    paper's Table 3."""
    return int(mask.sum()), int(pooled_mask.sum())
