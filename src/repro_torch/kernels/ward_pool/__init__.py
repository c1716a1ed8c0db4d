"""Agglomerative Ward token pooling: ``csrc/ward_pool.cu``."""
