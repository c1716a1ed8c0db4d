"""Pooling and index specs: plain frozen dataclasses with field checks.

Counterparts of ``src/repro/core/spec.py`` ``PoolingSpec``,
``IndexSpec`` and ``INDEX_PARAM_KEYS`` (the manifest "params" keys) for
the port's slice. The registries, argparse derivation and the
spec-from-manifest round trip of the reference are not ported (ROADMAP
queue 1, "Spec and facade").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

POOL_METHODS = ("none", "sequential", "kmeans", "ward")
PORTED_POOL_METHODS = POOL_METHODS
BACKENDS = ("flat", "hnsw", "plaid")
# MultiVectorIndex construction knobs: what an artifact manifest records
# under "params" (a reader of either package needs all nine)
INDEX_PARAM_KEYS = (
    "doc_maxlen", "n_centroids", "quant_bits", "nprobe",
    "t_cs", "ndocs", "hnsw_m", "hnsw_ef_construction",
    "hnsw_candidates")


@dataclass(frozen=True)
class PoolingSpec:
    """Which pooling method, at what factor. ``factor <= 1`` is the
    identity (the unpooled baseline) regardless of ``method``."""
    method: str = "ward"
    factor: int = 1

    def __post_init__(self):
        if self.method not in POOL_METHODS:
            raise ValueError(f"unknown pooling method {self.method!r}; "
                             f"known: {POOL_METHODS}")
        if int(self.factor) < 1:
            raise ValueError(f"pool factor must be >= 1, got {self.factor!r}")

    def apply(self, x, mask, impl: str = "auto"):
        """Pool one encode batch: (x [B,N,d], mask [B,N]) ->
        (pooled [B,N,d], pooled_mask [B,N])."""
        from repro_torch.core.pooling import pool_doc_embeddings
        method = "none" if int(self.factor) <= 1 else self.method
        return pool_doc_embeddings(x, mask, int(self.factor), method,
                                   impl=impl)

    def manifest_meta(self) -> Dict[str, Any]:
        """The ``pool`` entry an artifact manifest records."""
        return {"method": self.method, "factor": int(self.factor)}


@dataclass(frozen=True)
class IndexSpec:
    """Backend + construction knobs (defaults = the reference's)."""
    backend: str = "plaid"
    doc_maxlen: int = 256
    n_centroids: int = 256
    quant_bits: int = 2
    nprobe: int = 8
    t_cs: float = 0.3
    ndocs: int = 8192
    # HNSW (paper Appendix A)
    hnsw_m: int = 12
    hnsw_ef_construction: int = 200
    hnsw_candidates: int = 1024

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; known: "
                             f"{BACKENDS}")
        if int(self.quant_bits) not in (2, 4):
            raise ValueError(f"quant_bits must be 2 or 4, got "
                             f"{self.quant_bits!r}")
        for key in ("n_centroids", "nprobe", "ndocs", "doc_maxlen",
                    "hnsw_m", "hnsw_ef_construction", "hnsw_candidates"):
            if int(getattr(self, key)) < 1:
                raise ValueError(f"{key} must be >= 1, got "
                                 f"{getattr(self, key)!r}")

    def params(self) -> Dict[str, Any]:
        """Construction kwargs of ``MultiVectorIndex``."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "backend"}

    @classmethod
    def from_config(cls, cfg, **overrides) -> "IndexSpec":
        """The retrieval knobs of a ``ColbertConfig``; overrides win."""
        base = dict(backend=cfg.index_backend, doc_maxlen=cfg.doc_maxlen,
                    n_centroids=cfg.n_centroids, quant_bits=cfg.quant_bits,
                    nprobe=cfg.nprobe, t_cs=cfg.t_cs, ndocs=cfg.ndocs)
        base.update(overrides)
        return cls(**base)
