"""The system under test, built from a configuration file: the
``repro_torch`` encoder with the benchmark's weights, and its specs.

This module and the jobs are the only ones that import the program.
"""
from __future__ import annotations


def colbert_config(cfg: dict):
    from repro_torch.configs.base import ColbertConfig, TransformerConfig
    m = cfg["model"]
    trunk = TransformerConfig(
        name=f"{cfg['name']}-trunk", n_layers=m["n_layers"],
        d_model=m["d_model"], n_heads=m["n_heads"], n_kv_heads=m["n_heads"],
        d_ff=m["d_ff"], vocab_size=m["vocab_size"], causal=False,
        pos_emb="learned", gated_mlp=False, act="gelu", norm="layernorm",
        norm_eps=m["norm_eps"], max_seq_len=m["max_seq_len"],
        attn_full_threshold=4096, dtype=m["compute_dtype"],
        param_dtype=m["param_dtype"])
    ix = cfg["index"]
    return ColbertConfig(
        name=cfg["name"], trunk=trunk, proj_dim=m["proj_dim"],
        doc_maxlen=m["doc_maxlen"], query_maxlen=m["query_maxlen"],
        pool_method=cfg["pooling"]["method"],
        pool_factor=cfg["pooling"]["factor"], quant_bits=ix["quant_bits"],
        n_centroids=ix["n_centroids"], nprobe=ix["nprobe"], t_cs=ix["t_cs"],
        ndocs=ix["ndocs"])


def build_model(cfg: dict, weights, device):
    """The program's ColBERT holding ``weights`` (the benchmark's)."""
    from repro_torch.models.colbert import ColBERT
    model = ColBERT(colbert_config(cfg), device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def specs(cfg: dict):
    """(IndexSpec, PoolingSpec) of the configuration."""
    from repro_torch.core.spec import IndexSpec, PoolingSpec
    ix = cfg["index"]
    index = IndexSpec(backend=ix["backend"],
                      doc_maxlen=cfg["model"]["doc_maxlen"],
                      n_centroids=ix["n_centroids"],
                      quant_bits=ix["quant_bits"], nprobe=ix["nprobe"],
                      t_cs=ix["t_cs"], ndocs=ix["ndocs"])
    pool = PoolingSpec(cfg["pooling"]["method"], cfg["pooling"]["factor"])
    return index, pool


def launches() -> dict:
    from repro_torch.kernels import launch_counts
    return dict(launch_counts())
