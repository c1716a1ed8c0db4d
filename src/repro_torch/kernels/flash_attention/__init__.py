"""Causal online-softmax attention with GQA: ``csrc/flash_attention.cu``."""
