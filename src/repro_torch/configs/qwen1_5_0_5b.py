"""Qwen1.5-0.5B dense, QKV bias, MHA [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (kv=16 -> MHA) d_ff=2816 vocab=151936.
Copy of ``src/repro/configs/qwen1_5_0_5b.py`` (``CONFIG`` and the test-size
``SMOKE``).
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen1.5-0.5b",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = TransformerConfig(
    name="qwen1.5-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=88,
    vocab_size=512,
    qkv_bias=True,
    remat=False,
    attn_full_threshold=4096,
    max_seq_len=128,
)
