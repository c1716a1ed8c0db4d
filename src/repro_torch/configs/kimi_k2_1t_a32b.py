"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8.
Copy of ``src/repro/configs/kimi_k2_1t_a32b.py``
(``CONFIG`` and the test-size ``SMOKE``), without ``scan_layers``, which
has no PyTorch meaning.
"""
from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    moe=True,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    rope_theta=1_000_000.0,
    optimizer="adafactor",        # 1T params: factored 2nd moment or bust
    param_dtype="bfloat16",       # 1T f32 = 4TB; bf16 halves it
    train_microbatches=8,         # 256-batch as 8 x 32 grad-accum microbatches
    grad_accum_dtype="bfloat16",  # f32 accumulator alone would be 16GB/chip
)

# Reduced config for CPU smoke tests (same family: MoE + GQA)
SMOKE = TransformerConfig(
    name="kimi-k2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    moe=True,
    n_experts=8,
    top_k=2,
    moe_d_ff=96,
    remat=False,
    attn_full_threshold=4096,
    max_seq_len=128,
)
