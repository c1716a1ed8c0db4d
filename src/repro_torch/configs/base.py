"""Config dataclasses for the ColBERT encoder and its retrieval knobs.

Copies of ``src/repro/configs/base.py`` ``TransformerConfig`` and
``ColbertConfig``, keeping only the fields the ColBERT path reads.
Frozen, so ``dataclasses.replace`` makes variants (the tests run the
encoder with ``dtype="float32"``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    causal: bool = True
    qkv_bias: bool = False
    pos_emb: str = "rope"              # only "learned" is ported
    gated_mlp: bool = True
    act: str = "silu"
    norm: str = "rmsnorm"              # only "layernorm" is ported
    norm_eps: float = 1e-6
    max_seq_len: int = 32768
    dtype: str = "bfloat16"            # compute dtype
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)


@dataclass(frozen=True)
class ColbertConfig:
    name: str
    trunk: TransformerConfig
    proj_dim: int = 128
    doc_maxlen: int = 256
    query_maxlen: int = 32
    mask_punctuation: bool = True
    pool_method: str = "ward"
    pool_factor: int = 1
    index_backend: str = "plaid"
    quant_bits: int = 2
    n_centroids: int = 256
    nprobe: int = 8
    t_cs: float = 0.3
    ndocs: int = 8192
