"""Qwen2.5-14B dense, GQA, QKV bias [hf:Qwen/Qwen2.5 family; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
H=40 does not divide tp=16 -> sequence-parallel attention sharding.
Copy of ``src/repro/configs/qwen2_5_14b.py`` (``CONFIG`` and the test-size
``SMOKE``).
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    attn_shard="sequence",        # 40 % 16 != 0
    train_microbatches=4,
)

SMOKE = TransformerConfig(
    name="qwen2.5-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    remat=False,
    attn_full_threshold=4096,
    max_seq_len=128,
)
