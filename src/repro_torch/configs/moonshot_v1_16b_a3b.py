"""kimi/moonlight 16B-A3B MoE [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
Copy of ``src/repro/configs/moonshot_v1_16b_a3b.py``
(``CONFIG`` and the test-size ``SMOKE``).
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=True,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    rope_theta=1_000_000.0,
    optimizer="adamw",
    train_microbatches=4,
)

SMOKE = TransformerConfig(
    name="moonshot-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=80,
    vocab_size=512,
    moe=True,
    n_experts=4,
    top_k=2,
    moe_d_ff=80,
    remat=False,
    attn_full_threshold=4096,
    max_seq_len=128,
)
