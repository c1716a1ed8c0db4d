"""EmbeddingBag over stacked per-field tables
(``src/repro/models/recsys/embedding.py``) — the recsys hot path.

Layout: all ``n_sparse`` fields share one stacked table [F, V, D]
(fields with smaller vocabularies padded to V rows); lookups take ids
[B, F, M] (M = multi-hot bag size) -> bags [B, F, D] via sum or mean.

The gather is ``F.embedding`` over the table viewed as [F * V, D], field
f's ids offset by f * V: its backward sums each row's gradient by
sorting the ids (no atomics), and the gradient is dense, as the
reference's (AdamW then updates every row).

Over a mesh (a ``DTensor`` table, its rows sharded over ``model``:
``vocab_rows``) the gather keeps the row shard, as the reference's
per-field ``take`` lowers: each rank gathers, field by field, the rows
its shard holds from its local [F, V / n, D] table, the others masked
to zero, and the masked rows are summed over the mesh dims that shard
the rows (for the cells' one-id bags, the bags themselves); no table is
gathered. Each row is non-zero on one rank only, so the bags are the
single call's, bit for bit. The reference casts the
whole table to the compute dtype before it gathers; here the gathered
rows are cast, which gives the same values bit for bit without a
temporary copy of the table (3.3 GB in bf16 at dlrm-rm2's 26 x 1M x 64).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.segment import sorted_segment_sum
from repro_torch.models.layers import trunc_normal_
from repro_torch.sharding.api import constrain


def init_tables(tables: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """In place: stacked tables [F, V_max, D] truncated-normal(1/sqrt(D))
    (the reference's ``init_tables`` law); rows past a field's vocabulary
    are never hit but keep the stack rectangular."""
    return trunc_normal_(tables, 1.0 / float(tables.shape[-1]) ** 0.5,
                         generator)


def _field_rows(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, F, M] -> rows of the flattened [F * V, D] table."""
    F_, V = tables.shape[0], tables.shape[1]
    offs = torch.arange(F_, device=ids.device) * V
    return ids.long() + offs[None, :, None]


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor, *,
                  mode: str = "sum",
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """tables [F, V, D]; ids [B, F, M] -> bags [B, F, D] (sum or mean
    over M), in ``dtype`` (default the table's)."""
    from torch.distributed.tensor import DTensor
    tables = constrain(tables, None, "vocab_rows", None)
    if isinstance(tables, DTensor):
        rows = _sharded_rows(tables, ids, dtype)              # [B, F, M, D]
    else:
        flat = tables.reshape(-1, tables.shape[-1])
        rows = F.embedding(_field_rows(tables, ids), flat)
        if dtype is not None:
            rows = rows.to(dtype)
    if mode == "sum":
        bags = rows.sum(dim=2)
    elif mode == "mean":
        bags = rows.mean(dim=2)
    else:
        raise ValueError(mode)
    return constrain(bags, "batch", None, "embed")


def local_rows(table: torch.Tensor, offset: int, ids: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One rank's part of the gather: ``table`` [F, v, D] the rows
    [offset, offset + v) of each field's table; ids [B, F, M] (global
    rows) -> [B, F, M, D] in ``dtype``: the rows this shard holds, zero
    where another shard holds the id."""
    v = table.shape[1]
    local = ids.long() - offset
    held = (local >= 0) & (local < v)
    rows = F.embedding(_field_rows(table, torch.where(held, local, 0)),
                       table.reshape(-1, table.shape[-1]))
    if dtype is not None:
        rows = rows.to(dtype)
    return torch.where(held[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def _sharded_rows(tables, ids, dtype):
    """The gathered rows [B, F, M, D] of a row-sharded ``DTensor`` table:
    ``local_rows`` on this rank's shard and ids, reduced over the mesh
    dims that shard the rows; laid out as the ids over the others. The
    table's gradient is this rank's rows' (a partial sum over the ids'
    batch shards, which the gradient's layout then reduces)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.sharding.api import from_local, lay_out
    mesh, place = tables.device_mesh, tables.placements
    if any(p.is_shard() and p.dim != 1 for p in place):
        raise ValueError(f"tables laid out {place}: only the row axis may "
                         f"be split")
    ids = lay_out(ids, mesh, [
        Replicate() if t.is_shard(1) else p for t, p in zip(
            place, ids.placements if isinstance(ids, DTensor)
            else [Replicate()] * mesh.ndim)])
    _, off = compute_local_shape_and_global_offset(tables.shape, mesh, place)
    grads = [Partial() if i.is_shard() else t
             for t, i in zip(place, ids.placements)]
    rows = local_rows(tables.to_local(grad_placements=grads), off[1],
                      ids.to_local(), dtype)
    shape = (*ids.shape, tables.shape[-1])
    out = [Replicate() if t.is_shard(1) else i
           for t, i in zip(place, ids.placements)]
    part = [Partial() if t.is_shard(1) else i
            for t, i in zip(place, ids.placements)]
    return from_local(rows, mesh, part, shape,
                      grad_placements=out).redistribute(mesh, out)


def embedding_bag_ragged(tables: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int,
                         field_ids: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Ragged variant: flat_ids [NNZ], segment_ids [NNZ] -> bags
    [n_bags, D] (bag sizes vary; CSR offsets flattened on the host).
    ``field_ids`` picks each id's table (default field 0). The bag sum
    gathers each bag's rows through a padded table and sums them in id
    order (``core/segment.py`` ``sorted_segment_sum``)."""
    V = tables.shape[1]
    rows = flat_ids.long() if field_ids is None else (
        field_ids.long() * V + flat_ids.long())
    x = F.embedding(rows, tables.reshape(-1, tables.shape[-1]))
    if dtype is not None:
        x = x.to(dtype)
    return sorted_segment_sum(x, segment_ids.long(), n_bags)
