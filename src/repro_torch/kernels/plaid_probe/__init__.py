"""Fused PLAID centroid-interaction probe (stages 1 + 3): ``csrc/plaid_probe.cu``."""
