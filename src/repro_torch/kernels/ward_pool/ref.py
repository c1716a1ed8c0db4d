"""Plain PyTorch version of the Ward pooling kernel.

Counterpart of ``src/repro/kernels/ward_pool/ref.py``: the oracle is the
port's ``core/ward.py`` loop, which the CUDA kernel must match merge for
merge (same first-occurrence row-major tie-break).
"""
from __future__ import annotations

from repro_torch.core.ward import ward_cluster_batch


def ward_assign_ref(x, mask, factor: int):
    """[B, N, d] x [B, N] -> [B, N] int32 representative token ids."""
    return ward_cluster_batch(x, mask, factor)
