"""Config dataclasses of the port: the transformer trunks (dense and
MoE), ColBERT, DimeNet, the recsys models, and the shape cells.

Copies of ``src/repro/configs/base.py``. Each dataclass keeps the
fields the ported paths read, each with the reference's default, so a
config copied here equals the reference's on every field it has. The
sharding hints ``attn_shard`` and ``fsdp_params`` are read by
``launch/input_specs.py``, as is ``unroll_scans`` (a prefill cell's
attention chunk); the reference's ``scan_layers`` (layers under one
``lax.scan``) has no PyTorch meaning (the port loops over its layers)
and is left out, as is DimeNet's ``unroll_scans``. Frozen, so
``dataclasses.replace`` makes variants (the tests run in
``dtype="float32"``; the flash kernel is switched on with
``use_flash_kernel=True``).

``ShapeCell`` and the ``*_SHAPES`` tuples are the reference's
(input-shape x step-kind) cells, framework-free data; ``shapes_for``
picks a config's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def asdict(cfg) -> dict:
    """A config as nested plain dicts (checkpoint and manifest
    metadata)."""
    return dataclasses.asdict(cfg)


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

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                  # per-expert FFN width (d_ff if 0)
    n_shared_experts: int = 0
    first_dense_layers: int = 0        # leading dense layers before MoE stack
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01      # load-balance loss coefficient
    moe_impl: str = "capacity"         # "capacity" | "ep" | "dense" (oracle)

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

    # --- sharding hints (launch/input_specs.py) ---
    attn_shard: str = "heads"          # "heads" | "sequence" (when H % tp != 0)
    fsdp_params: bool = True           # ZeRO-3: shard weights on data axis too

    # --- training ---
    optimizer: str = "adamw"           # "adamw" | "adafactor"
    train_microbatches: int = 1        # grad accumulation in the LM step
    grad_accum_dtype: str = "float32"  # the accumulator's dtype
    # the reference's analysis mode (its scans unrolled); here it sets a
    # prefill cell's attention chunk as the reference's does
    unroll_scans: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.moe and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (the reference's, term for term)."""
        d, dh, H, KV = self.d_model, self.d_head, self.n_heads, self.n_kv_heads
        attn = d * (H * dh) * 2 + d * (KV * dh) * 2          # q,o + k,v
        if self.qkv_bias:
            attn += (H + 2 * KV) * dh
        dense_ffn = d * self.d_ff * (3 if self.gated_mlp else 2)
        n_moe = (max(self.n_layers - self.first_dense_layers, 0)
                 if self.moe else 0)
        n_dense = self.n_layers - n_moe
        total = n_dense * (attn + dense_ffn)
        if self.moe:
            expert = d * self.moe_d_ff * (3 if self.gated_mlp else 2)
            router = d * self.n_experts
            shared = self.n_shared_experts * expert
            total += n_moe * (attn + self.n_experts * expert + router + shared)
        total += 2 * self.n_layers * d                        # norms
        total += self.vocab_size * d                          # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                      # lm head
        if self.pos_emb == "learned":
            total += self.max_seq_len * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        expert = d * self.moe_d_ff * (3 if self.gated_mlp else 2)
        n_moe = max(self.n_layers - self.first_dense_layers, 0)
        inactive = n_moe * (self.n_experts - self.top_k) * expert
        return self.param_count() - inactive


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
    # "einsum" | "blocked"; both run the maxsim kernel on the card; a
    # trace on ``meta`` (the dry run) scores in one pass or in blocks of
    # ``maxsim_block`` docs, as the reference's step does
    maxsim_impl: str = "einsum"
    maxsim_block: int = 512


@dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat_in: int = 0                 # node feature dim (0 = atom types)
    n_targets: int = 1
    cutoff: float = 5.0
    envelope_exponent: int = 5
    n_atom_types: int = 95
    # triplet budget per edge: n_triplets = n_edges * triplet_cap
    triplet_cap: int = 8
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                          # "wide_deep" | "deepfm" | "fm" | "dlrm"
    n_sparse: int
    embed_dim: int
    n_dense: int = 0
    vocab_sizes: Tuple[int, ...] = ()  # per-field table rows (default 1M)
    mlp_dims: Tuple[int, ...] = ()
    bot_mlp_dims: Tuple[int, ...] = ()
    top_mlp_dims: Tuple[int, ...] = ()
    interaction: str = "dot"           # "dot" | "fm" | "fm-2way" | "concat"
    multi_hot: int = 1                 # ids per sparse field (bag size)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"

    def __post_init__(self):
        if not self.vocab_sizes:
            object.__setattr__(
                self, "vocab_sizes", tuple([1_000_000] * self.n_sparse))
        if len(self.vocab_sizes) != self.n_sparse:
            raise ValueError(f"{self.name}: {len(self.vocab_sizes)} vocab "
                             f"sizes for {self.n_sparse} sparse fields")


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape x step-kind) cell of the dry-run matrix."""
    name: str
    kind: str                          # train | prefill | decode | serve | ...
    dims: Tuple[Tuple[str, int], ...]  # ordered (name, value) pairs

    def dim(self, key: str) -> int:
        for k, v in self.dims:
            if k == key:
                return v
        raise KeyError(key)

    def get(self, key: str, default=None):
        for k, v in self.dims:
            if k == key:
                return v
        return default


LM_SHAPES = (
    ShapeCell("train_4k", "train",
              (("seq_len", 4096), ("global_batch", 256))),
    ShapeCell("prefill_32k", "prefill",
              (("seq_len", 32768), ("global_batch", 32))),
    ShapeCell("decode_32k", "decode",
              (("seq_len", 32768), ("global_batch", 128))),
    ShapeCell("long_500k", "decode",
              (("seq_len", 524288), ("global_batch", 1))),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "train",
              (("n_nodes", 2708), ("n_edges", 10556), ("d_feat", 1433))),
    ShapeCell("minibatch_lg", "train",
              (("n_nodes", 232965), ("n_edges", 114615892),
               ("batch_nodes", 1024), ("fanout0", 15), ("fanout1", 10))),
    ShapeCell("ogb_products", "train",
              (("n_nodes", 2449029), ("n_edges", 61859140), ("d_feat", 100))),
    ShapeCell("molecule", "train",
              (("n_nodes", 30), ("n_edges", 64), ("batch", 128))),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", (("batch", 65536),)),
    ShapeCell("serve_p99", "serve", (("batch", 512),)),
    ShapeCell("serve_bulk", "serve", (("batch", 262144),)),
    ShapeCell("retrieval_cand", "serve",
              (("batch", 1), ("n_candidates", 1_000_000))),
)

# ColBERT's own (extra, beyond the 40 assigned cells)
COLBERT_SHAPES = (
    ShapeCell("index_build", "index", (("n_docs", 4096), ("doc_len", 256))),
    ShapeCell("search", "search",
              (("n_queries", 64), ("query_len", 32),
               ("n_docs", 65536), ("doc_len", 256))),
)


def shapes_for(cfg) -> Tuple[ShapeCell, ...]:
    if isinstance(cfg, TransformerConfig):
        return LM_SHAPES
    if isinstance(cfg, DimeNetConfig):
        return GNN_SHAPES
    if isinstance(cfg, RecsysConfig):
        return RECSYS_SHAPES
    if isinstance(cfg, ColbertConfig):
        return COLBERT_SHAPES
    raise TypeError(type(cfg))
