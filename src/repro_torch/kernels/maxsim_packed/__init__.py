"""Compressed-domain MaxSim rerank (PLAID stage 4): ``csrc/maxsim_packed.cu``."""
