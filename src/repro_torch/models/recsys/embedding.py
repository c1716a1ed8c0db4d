"""EmbeddingBag over stacked per-field tables
(``src/repro/models/recsys/embedding.py``) — the recsys hot path.

Layout: all ``n_sparse`` fields share one stacked table [F, V, D]
(fields with smaller vocabularies padded to V rows); lookups take ids
[B, F, M] (M = multi-hot bag size) -> bags [B, F, D] via sum or mean.

The gather is ``F.embedding`` over the table viewed as [F * V, D], field
f's ids offset by f * V: its backward sums each row's gradient by
sorting the ids (no atomics), and the gradient is dense, as the
reference's (AdamW then updates every row). The reference casts the
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
    flat = tables.reshape(-1, tables.shape[-1])
    rows = F.embedding(_field_rows(tables, ids), flat)        # [B, F, M, D]
    if dtype is not None:
        rows = rows.to(dtype)
    if mode == "sum":
        return rows.sum(dim=2)
    if mode == "mean":
        return rows.mean(dim=2)
    raise ValueError(mode)


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
