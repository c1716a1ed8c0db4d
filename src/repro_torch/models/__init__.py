"""The ColBERT encoder as PyTorch modules."""
