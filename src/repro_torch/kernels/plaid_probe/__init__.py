"""Fused PLAID centroid-interaction probe (stages 1 + 3): ``csrc/plaid_probe.cu``."""
from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores

__all__ = ["plaid_probe_scores"]
