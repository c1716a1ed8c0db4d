"""ColBERTv2 [arXiv:2112.01488] and its JaColBERTv2 analogue.

Copies of ``src/repro/configs/colbertv2.py``: a BERT-base trunk
(12 layers, d_model 768, 12 heads, learned positions, GELU MLP,
LayerNorm eps 1e-12) with a 128-d projection; doc_maxlen 256 (300 for
JaColBERTv2), query_maxlen 32. ``SMOKE`` is the 2-layer test size.
"""
from repro_torch.configs.base import ColbertConfig, TransformerConfig

TRUNK = TransformerConfig(
    name="colbertv2-trunk", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab_size=30522, causal=False,
    pos_emb="learned", gated_mlp=False, act="gelu", norm="layernorm",
    norm_eps=1e-12, max_seq_len=512, attn_full_threshold=4096)

CONFIG = ColbertConfig(name="colbertv2", trunk=TRUNK, proj_dim=128,
                       doc_maxlen=256, query_maxlen=32)

JA_TRUNK = TransformerConfig(
    name="jacolbertv2-trunk", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab_size=32768, causal=False,
    pos_emb="learned", gated_mlp=False, act="gelu", norm="layernorm",
    norm_eps=1e-12, max_seq_len=512, attn_full_threshold=4096)

JA_CONFIG = ColbertConfig(name="jacolbertv2", trunk=JA_TRUNK, proj_dim=128,
                          doc_maxlen=300, query_maxlen=32)

SMOKE_TRUNK = TransformerConfig(
    name="colbert-smoke-trunk", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=1024, causal=False,
    pos_emb="learned", gated_mlp=False, act="gelu", norm="layernorm",
    remat=False, max_seq_len=64, attn_full_threshold=4096)

SMOKE = ColbertConfig(name="colbert-smoke", trunk=SMOKE_TRUNK, proj_dim=32,
                      doc_maxlen=48, query_maxlen=8, n_centroids=32)
