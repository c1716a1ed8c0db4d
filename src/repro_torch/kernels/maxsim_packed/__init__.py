"""Compressed-domain MaxSim rerank (PLAID stage 4): ``csrc/maxsim_packed.cu``."""
from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank

__all__ = ["maxsim_packed_rerank"]
