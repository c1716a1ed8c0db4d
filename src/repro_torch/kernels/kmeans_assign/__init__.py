"""Fused similarity + masked first-argmax k-means assignment: ``csrc/kmeans_assign.cu``."""
