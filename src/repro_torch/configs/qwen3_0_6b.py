"""Qwen3-0.6B dense, qk_norm, GQA [hf:Qwen/Qwen3 family; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
Copy of ``src/repro/configs/qwen3_0_6b.py`` (``CONFIG`` and the test-size
``SMOKE``).
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = TransformerConfig(
    name="qwen3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    qk_norm=True,
    remat=False,
    attn_full_threshold=4096,
    max_seq_len=128,
)
