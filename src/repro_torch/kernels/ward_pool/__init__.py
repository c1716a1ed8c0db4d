"""Agglomerative Ward token pooling: ``csrc/ward_pool.cu``.

Re-exports the reference's ``ward_assign`` (the wrapper) and
``ward_assign_ref`` (its plain version). ``ops`` imports ``core.ward``,
whose package imports ``core.pooling``, which imports ``ops``: the
import is safe from any side (``tests/test_torch_public_api.py`` imports
each subpackage first in a fresh process), since no module on the cycle
reads another's names at import time.
"""
from repro_torch.kernels.ward_pool.ops import ward_assign
from repro_torch.kernels.ward_pool.ref import ward_assign_ref

__all__ = ["ward_assign", "ward_assign_ref"]
