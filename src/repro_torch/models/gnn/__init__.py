"""DimeNet and its neighbor sampler (``src/repro/models/gnn``)."""
from repro_torch.models.gnn.dimenet import (DimeNet, build_triplets,
                                            dimenet_forward, dimenet_loss,
                                            init_dimenet)
from repro_torch.models.gnn.sampler import NeighborSampler

__all__ = ["DimeNet", "dimenet_forward", "dimenet_loss", "init_dimenet",
           "build_triplets", "NeighborSampler"]
