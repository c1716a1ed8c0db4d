"""Config dataclasses of the port: the transformer trunk and ColBERT.

Copies of ``src/repro/configs/base.py`` ``TransformerConfig`` and
``ColbertConfig``. ``TransformerConfig`` keeps the fields the ported
encoder, causal-LM and training paths read, each with the reference's
default, so a config copied here equals the reference's on every field
it has. The reference's sharding hints (``scan_layers``, ``attn_shard``,
``fsdp_params``, ``unroll_scans``) are left out until sharding is ported
and reads them. Frozen, so
``dataclasses.replace`` makes variants (the tests run in
``dtype="float32"``; the flash kernel is switched on with
``use_flash_kernel=True``).
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

    # --- MoE (not ported: a MoE config raises NotImplementedError) ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                  # per-expert FFN width (d_ff if 0)
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    moe_impl: str = "capacity"

    # --- attention flavour ---
    causal: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    pos_emb: str = "rope"              # "rope" | "learned"
    attn_chunk: int = 1024             # kv/q chunk of the online-softmax path
    attn_full_threshold: int = 2048    # full attention up to this length
    use_flash_kernel: bool = False     # causal, unmasked: the flash kernel

    # --- mlp / norm ---
    gated_mlp: bool = True             # SwiGLU-style
    act: str = "silu"
    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- execution ---
    max_seq_len: int = 32768
    dtype: str = "bfloat16"            # compute dtype
    param_dtype: str = "float32"
    remat: bool = True                 # recompute each block in backward
    logits_chunk: int = 1024           # seq-chunking of the xent loss

    # --- training ---
    optimizer: str = "adamw"           # "adamw" | "adafactor"
    train_microbatches: int = 1        # grad accumulation in the LM step
    grad_accum_dtype: str = "float32"  # the accumulator's dtype

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.moe and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


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
    # serving-step scoring (launch/steps.py make_colbert_search_step):
    # "einsum" | "blocked"; both run the maxsim kernel here
    maxsim_impl: str = "einsum"
