"""Sharding of the port (``src/repro/sharding/``): logical-axis rules over
a mesh (``api``) and parameter specs per architecture (``params``)."""
from repro_torch.sharding.api import (  # noqa: F401
    MeshContext,
    P,
    PartitionSpec,
    constrain,
    current_ctx,
    logical_spec,
    mesh_context,
    placements,
)
