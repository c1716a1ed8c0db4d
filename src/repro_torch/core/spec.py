"""Typed specs, one config surface from build through persist to serve.

Counterpart of ``src/repro/core/spec.py``, copied (the reference module
is importable only with JAX, through ``repro/core/__init__.py``):

  * the pooling-strategy registry (``register_pooling_strategy``,
    ``pooling_strategy``, ``pooling_methods``): ``PoolingSpec.apply``
    resolves its method there, so a new policy is one registration;
  * the backend registry (``BackendInfo``, ``register_backend``,
    ``backend_info``, ``backend_names``): flat, hnsw, plaid and the
    pooled cascade; ``repro_torch.api`` fills in their builders;
  * the frozen specs ``PoolingSpec``, ``IndexSpec``, ``ShardSpec``,
    ``ServeSpec`` and ``RetrieverSpec`` (``to_dict`` / ``from_dict`` /
    ``replace``), whose ``to_dict()`` equals the reference's;
  * the manifest round trip (``manifest_meta_for``,
    ``retriever_spec_from_manifest``) and the argparse derivation
    (``add_spec_args``, ``spec_from_args``).

Nothing here imports index, persist or model code at module level.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

# MultiVectorIndex construction knobs: what an artifact manifest records
# under "params", and what ShardedIndex forwards to every shard
INDEX_PARAM_KEYS: Tuple[str, ...] = (
    "doc_maxlen", "n_centroids", "quant_bits", "nprobe",
    "t_cs", "ndocs", "hnsw_m", "hnsw_ef_construction",
    "hnsw_candidates")
# CascadeIndex construction knobs (its manifest records them top-level)
CASCADE_PARAM_KEYS: Tuple[str, ...] = (
    "coarse_factor", "fine_factor", "candidates", "doc_maxlen")
# the index classes MultiVectorIndex builds (the cascade is its own)
BACKENDS = ("flat", "hnsw", "plaid")


# ---------------------------------------------------------------------------
# Pooling strategy registry
# ---------------------------------------------------------------------------
# strategy(x [B, N, d], mask [B, N] bool, factor) -> (pooled [B, M, d],
# pooled_mask [B, M] bool): pooled vectors scattered into slots. A
# strategy may return numpy arrays; the Indexer moves them to its device.
PoolingStrategy = Callable[..., Tuple[Any, Any]]

# the paper's methods, implemented by core/pooling.pool_doc_embeddings
BUILTIN_POOL_METHODS: Tuple[str, ...] = ("none", "sequential", "kmeans",
                                         "ward")
POOL_METHODS = BUILTIN_POOL_METHODS
PORTED_POOL_METHODS = POOL_METHODS

_POOLING_REGISTRY: Dict[str, PoolingStrategy] = {}


def register_pooling_strategy(name: str, strategy: PoolingStrategy,
                              overwrite: bool = False) -> None:
    """Register a pooling policy under ``name``, so that
    ``PoolingSpec(method=name)`` resolves to it everywhere."""
    if not name or not isinstance(name, str):
        raise ValueError(f"strategy name must be a non-empty str, "
                         f"got {name!r}")
    if not overwrite and (name in BUILTIN_POOL_METHODS
                          or name in _POOLING_REGISTRY):
        raise ValueError(f"pooling strategy {name!r} already registered "
                         f"(pass overwrite=True to replace it)")
    _POOLING_REGISTRY[name] = strategy


def _builtin_strategy(method: str) -> PoolingStrategy:
    def run(x, mask, factor: int, impl: str = "auto"):
        from repro_torch.core.pooling import pool_doc_embeddings
        return pool_doc_embeddings(x, mask, factor, method, impl=impl)
    return run


def pooling_strategy(name: str) -> PoolingStrategy:
    """Resolve a method name: registered strategies shadow builtins."""
    if name in _POOLING_REGISTRY:
        return _POOLING_REGISTRY[name]
    if name in BUILTIN_POOL_METHODS:
        return _builtin_strategy(name)
    raise KeyError(f"unknown pooling method {name!r}; known: "
                   f"{pooling_methods()}")


def pooling_methods() -> Tuple[str, ...]:
    """Builtins, then registered strategies."""
    return BUILTIN_POOL_METHODS + tuple(
        n for n in _POOLING_REGISTRY if n not in BUILTIN_POOL_METHODS)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BackendInfo:
    """One retrieval backend the facade can build, persist and serve."""
    name: str
    artifact_kind: str              # manifest "kind" it persists as
    param_keys: Tuple[str, ...]     # IndexSpec fields that apply to it
    # builder(model, docs, spec, out_dir, encode_batch, device) ->
    # (index, IndexStats); filled in by repro_torch.api
    builder: Optional[Callable] = None


_BACKEND_REGISTRY: Dict[str, BackendInfo] = {}


def register_backend(name: str, artifact_kind: str,
                     param_keys: Sequence[str],
                     builder: Optional[Callable] = None,
                     overwrite: bool = False) -> None:
    if not overwrite and name in _BACKEND_REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    _BACKEND_REGISTRY[name] = BackendInfo(
        name=name, artifact_kind=artifact_kind,
        param_keys=tuple(param_keys), builder=builder)


def backend_info(name: str) -> BackendInfo:
    if name not in _BACKEND_REGISTRY:
        raise KeyError(f"unknown backend {name!r}; known: "
                       f"{backend_names()}")
    return _BACKEND_REGISTRY[name]


def backend_names() -> Tuple[str, ...]:
    return tuple(_BACKEND_REGISTRY)


for _b in BACKENDS:
    register_backend(_b, "multi_vector_index", INDEX_PARAM_KEYS)
register_backend("cascade", "cascade_index", CASCADE_PARAM_KEYS)


# ---------------------------------------------------------------------------
# Spec base
# ---------------------------------------------------------------------------
def _from_dict(cls, d: Dict[str, Any]):
    """Strict constructor: unknown keys raise."""
    if not isinstance(d, dict):
        raise ValueError(f"{cls.__name__} expects a dict, got {type(d)}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys {sorted(unknown)}; "
                         f"known: {sorted(names)}")
    return cls(**d)


class _SpecBase:
    """Serialization shared by the frozen spec dataclasses."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        return _from_dict(cls, d)

    def replace(self, **kw):
        """A copy with fields replaced; unknown keys raise TypeError."""
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The specs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PoolingSpec(_SpecBase):
    """Which pooling method, at what factor. ``factor <= 1`` is the
    identity (the unpooled baseline) regardless of ``method``.
    ``ward_kernel`` is a runtime choice, never persisted: ``"ref"`` pools
    Ward through the plain version, ``"auto"`` / ``"kernel"`` through the
    ``ward_pool`` kernel on the card."""
    method: str = field(default="ward", metadata={
        "help": "token pooling method", "choices": pooling_methods})
    factor: int = field(default=1, metadata={
        "help": "pooling factor (1 = unpooled baseline)"})
    ward_kernel: str = field(default="auto", metadata={
        "help": "ward clustering path: the kernel or the plain version",
        "choices": ("auto", "kernel", "ref")})

    def __post_init__(self):
        if not isinstance(self.method, str) or not self.method:
            raise ValueError(f"pooling method must be a non-empty str, "
                             f"got {self.method!r}")
        if int(self.factor) < 1:
            raise ValueError(f"pool factor must be >= 1, got {self.factor!r}")
        if self.ward_kernel not in ("auto", "kernel", "ref"):
            raise ValueError(f"ward_kernel must be auto|kernel|ref, "
                             f"got {self.ward_kernel!r}")

    def apply(self, x, mask, impl: str = "auto"):
        """Pool one encode batch: (x [B,N,d], mask [B,N]) ->
        (pooled, pooled_mask), through the strategy registry."""
        if int(self.factor) <= 1:
            return _builtin_strategy("none")(x, mask, 1)
        if self.method in _POOLING_REGISTRY:
            return _POOLING_REGISTRY[self.method](x, mask, int(self.factor))
        if self.method == "ward" and self.ward_kernel == "ref":
            impl = "ref"
        return pooling_strategy(self.method)(x, mask, int(self.factor),
                                             impl=impl)

    def manifest_meta(self) -> Dict[str, Any]:
        """The ``pool`` entry an artifact manifest records."""
        return {"method": self.method, "factor": int(self.factor)}


@dataclass(frozen=True)
class IndexSpec(_SpecBase):
    """Backend + construction knobs (defaults = the reference's)."""
    backend: str = field(default="plaid", metadata={
        "help": "index backend", "choices": backend_names})
    doc_maxlen: int = 256
    # PLAID
    n_centroids: int = 256
    quant_bits: int = 2
    nprobe: int = 8
    t_cs: float = 0.3
    ndocs: int = 8192
    # HNSW (paper Appendix A)
    hnsw_m: int = 12
    hnsw_ef_construction: int = 200
    hnsw_candidates: int = 1024
    # the pooled cascade (retrieval/cascade.py)
    coarse_factor: int = 6
    fine_factor: int = 2
    candidates: int = 32

    def __post_init__(self):
        if self.backend not in _BACKEND_REGISTRY:
            raise ValueError(f"unknown backend {self.backend!r}; known: "
                             f"{backend_names()}")
        if int(self.quant_bits) not in (2, 4):
            raise ValueError(f"quant_bits must be 2 or 4, got "
                             f"{self.quant_bits!r}")
        for key in ("n_centroids", "nprobe", "ndocs", "doc_maxlen",
                    "hnsw_m", "hnsw_ef_construction", "hnsw_candidates"):
            if int(getattr(self, key)) < 1:
                raise ValueError(f"{key} must be >= 1, got "
                                 f"{getattr(self, key)!r}")

    @property
    def artifact_kind(self) -> str:
        return backend_info(self.backend).artifact_kind

    def params(self) -> Dict[str, Any]:
        """The construction kwargs of this backend's index class: what
        the manifest records."""
        return {k: getattr(self, k)
                for k in backend_info(self.backend).param_keys}

    def generic_params(self) -> Dict[str, Any]:
        """The ``INDEX_PARAM_KEYS`` values whatever the backend (a
        cascade manifest records them too, so the spec round-trips)."""
        return {k: getattr(self, k) for k in INDEX_PARAM_KEYS}

    @classmethod
    def from_config(cls, cfg, backend: Optional[str] = None,
                    **overrides) -> "IndexSpec":
        """The retrieval knobs of a ``ColbertConfig``; overrides win."""
        base = dict(backend=backend or cfg.index_backend,
                    doc_maxlen=cfg.doc_maxlen, n_centroids=cfg.n_centroids,
                    quant_bits=cfg.quant_bits, nprobe=cfg.nprobe,
                    t_cs=cfg.t_cs, ndocs=cfg.ndocs)
        base.update(overrides)
        return _from_dict(cls, base)

    @classmethod
    def from_manifest_params(cls, backend: str,
                             params: Dict[str, Any]) -> "IndexSpec":
        """From a manifest's ``params``: unknown keys raise, missing keys
        take the defaults."""
        unknown = set(params) - set(INDEX_PARAM_KEYS)
        if unknown:
            raise ValueError(f"unknown index params {sorted(unknown)}")
        return cls(backend=backend, **params)


@dataclass(frozen=True)
class ShardSpec(_SpecBase):
    """Streaming-build / sharded-layout knobs (core/sharded.py)."""
    shard_max_vectors: int = field(default=0, metadata={
        "help": "build via the streaming path, flushing a new shard "
                "every N pooled vectors (0 = monolithic)"})
    probe_threads: int = field(default=0, metadata={
        "help": "shard probe workers per sharded index "
                "(0 = auto: min(8, cores))"})

    def __post_init__(self):
        if int(self.shard_max_vectors) < 0:
            raise ValueError(f"shard_max_vectors must be >= 0, got "
                             f"{self.shard_max_vectors!r}")
        if int(self.probe_threads) < 0:
            raise ValueError(f"probe_threads must be >= 0, got "
                             f"{self.probe_threads!r}")

    @property
    def sharded(self) -> bool:
        return int(self.shard_max_vectors) > 0


@dataclass(frozen=True)
class ServeSpec(_SpecBase):
    """Serving-runtime knobs, never persisted. The port has no serving
    runtime yet (ROADMAP queue 1, item 6); the spec is carried so that
    specs round-trip with the reference's."""
    max_batch: int = field(default=32, metadata={
        "help": "engine coalescing cap / largest shape bucket"})
    max_wait_ms: float = field(default=2.0, metadata={
        "help": "engine batcher flush deadline"})
    k: int = field(default=10, metadata={
        "help": "results returned per query"})
    poll_interval_s: float = field(default=0.2, metadata={
        "cli": False, "help": "index-dir hot-swap poll interval"})
    pipeline_depth: Optional[int] = field(default=None, metadata={
        "cli": False,
        "help": "encode/search overlap depth (None = auto by cores)"})
    warmup_on_start: bool = field(default=True, metadata={
        "cli": False, "help": "warm every shape bucket at start()"})
    n_replicas: int = field(default=1, metadata={
        "help": "replica groups the engine routes microbatches across"})

    def __post_init__(self):
        if int(self.max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.max_batch!r}")
        if int(self.n_replicas) < 1:
            raise ValueError(f"n_replicas must be >= 1, got "
                             f"{self.n_replicas!r}")


@dataclass(frozen=True)
class RetrieverSpec(_SpecBase):
    """The whole pipeline: pool -> index -> shard -> serve."""
    pooling: PoolingSpec = field(default_factory=PoolingSpec)
    index: IndexSpec = field(default_factory=IndexSpec)
    shard: ShardSpec = field(default_factory=ShardSpec)
    serve: ServeSpec = field(default_factory=ServeSpec)

    def __post_init__(self):
        if self.shard.sharded and self.index.backend == "cascade":
            raise ValueError("cascade indexes have no sharded layout "
                             "(shard_max_vectors must be 0)")

    def to_dict(self) -> Dict[str, Any]:
        return {"pooling": self.pooling.to_dict(),
                "index": self.index.to_dict(),
                "shard": self.shard.to_dict(),
                "serve": self.serve.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RetrieverSpec":
        if not isinstance(d, dict):
            raise ValueError(f"RetrieverSpec expects a dict, got {type(d)}")
        unknown = set(d) - {"pooling", "index", "shard", "serve"}
        if unknown:
            raise ValueError(f"unknown RetrieverSpec keys {sorted(unknown)}")
        return cls(
            pooling=PoolingSpec.from_dict(d.get("pooling", {})),
            index=IndexSpec.from_dict(d.get("index", {})),
            shard=ShardSpec.from_dict(d.get("shard", {})),
            serve=ServeSpec.from_dict(d.get("serve", {})))

    @classmethod
    def from_config(cls, cfg, **index_overrides) -> "RetrieverSpec":
        return cls(pooling=PoolingSpec(method=cfg.pool_method,
                                       factor=max(int(cfg.pool_factor), 1)),
                   index=IndexSpec.from_config(cfg, **index_overrides))

    @classmethod
    def coerce(cls, spec, cfg=None) -> "RetrieverSpec":
        """A RetrieverSpec, a bare IndexSpec / PoolingSpec / ShardSpec
        (the rest from ``cfg``), a dict (omitted sections from ``cfg``),
        or None."""
        if spec is None:
            return cls.from_config(cfg) if cfg is not None else cls()
        if isinstance(spec, cls):
            return spec
        base = cls.from_config(cfg) if cfg is not None else cls()
        if isinstance(spec, IndexSpec):
            return base.replace(index=spec)
        if isinstance(spec, PoolingSpec):
            return base.replace(pooling=spec)
        if isinstance(spec, ShardSpec):
            return base.replace(shard=spec)
        if isinstance(spec, dict):
            full = cls.from_dict(spec)      # validates every section
            return base.replace(**{name: getattr(full, name)
                                   for name in ("pooling", "index",
                                                "shard", "serve")
                                   if name in spec})
        raise TypeError(f"cannot coerce {type(spec).__name__} to "
                        f"RetrieverSpec")


# ---------------------------------------------------------------------------
# Manifest round trip
# ---------------------------------------------------------------------------
def manifest_meta_for(spec: RetrieverSpec) -> Dict[str, Any]:
    """The spec's entries in the manifest a save writes: the inverse of
    ``retriever_spec_from_manifest``."""
    meta: Dict[str, Any] = {
        "kind": spec.index.artifact_kind,
        "pool": spec.pooling.manifest_meta(),
    }
    if spec.index.backend == "cascade":
        meta.update({k: getattr(spec.index, k) for k in CASCADE_PARAM_KEYS})
        meta["params"] = spec.index.generic_params()
    else:
        meta["backend"] = spec.index.backend
        meta["params"] = spec.index.params()
        if spec.shard.sharded:
            meta["kind"] = "sharded_index"
            meta["shard_max_vectors"] = int(spec.shard.shard_max_vectors)
            # auto (0) is written only when pinned
            if int(spec.shard.probe_threads) > 0:
                meta["probe_threads"] = int(spec.shard.probe_threads)
    return meta


def retriever_spec_from_manifest(manifest: Dict[str, Any],
                                 serve: Optional[ServeSpec] = None
                                 ) -> RetrieverSpec:
    """The build-time spec of an artifact; ``serve`` is runtime-only and
    comes back default unless given."""
    kind = manifest.get("kind")
    pool_meta = manifest.get("pool")
    pooling = (PoolingSpec.from_dict(pool_meta) if pool_meta
               else PoolingSpec())
    shard = ShardSpec()
    if kind == "cascade_index":
        index = IndexSpec.from_manifest_params(
            "cascade", dict(manifest.get("params", {}))).replace(**{
                k: manifest[k] for k in CASCADE_PARAM_KEYS if k in manifest})
    elif kind in ("multi_vector_index", "sharded_index"):
        index = IndexSpec.from_manifest_params(
            manifest.get("backend", "plaid"),
            dict(manifest.get("params", {})))
        if kind == "sharded_index":
            shard = ShardSpec(
                shard_max_vectors=int(manifest.get("shard_max_vectors", 0)),
                probe_threads=int(manifest.get("probe_threads", 0)))
    else:
        raise ValueError(f"manifest kind {kind!r} carries no retriever "
                         f"spec")
    return RetrieverSpec(pooling=pooling, index=index, shard=shard,
                         serve=serve or ServeSpec())


# ---------------------------------------------------------------------------
# Argparse derivation
# ---------------------------------------------------------------------------
def add_spec_args(parser, spec_cls, prefix: str = "",
                  defaults: Optional[Dict[str, Any]] = None,
                  only: Optional[Sequence[str]] = None):
    """One ``--{prefix}{field}`` flag per field of ``spec_cls`` (fields
    with ``cli=False`` metadata skipped); type and default from the
    dataclass, help and choices from the metadata. ``defaults``
    overrides defaults, ``only`` restricts the fields."""
    defaults = defaults or {}
    for f in dataclasses.fields(spec_cls):
        if f.metadata.get("cli") is False:
            continue
        if only is not None and f.name not in only:
            continue
        default = defaults.get(f.name, f.default)
        kw: Dict[str, Any] = {
            "default": default,
            "help": f.metadata.get("help", f.name)
            + f" (default: {default})",
        }
        choices = f.metadata.get("choices")
        if callable(choices):
            choices = choices()
        if choices:
            kw["choices"] = choices
        if not isinstance(default, bool) and isinstance(
                default, (int, float, str)):
            kw["type"] = type(default)
        flag = "--" + (prefix + f.name).replace("_", "-")
        parser.add_argument(flag, **kw)
    return parser


def spec_from_args(spec_cls, args, prefix: str = "",
                   only: Optional[Sequence[str]] = None, **overrides):
    """The spec back out of parsed args (inverse of ``add_spec_args``);
    fields without an arg keep their defaults, ``overrides`` win."""
    kw: Dict[str, Any] = {}
    for f in dataclasses.fields(spec_cls):
        if f.metadata.get("cli") is False:
            continue
        if only is not None and f.name not in only:
            continue
        attr = (prefix + f.name).replace("-", "_")
        if hasattr(args, attr):
            kw[f.name] = getattr(args, attr)
    kw.update(overrides)
    return spec_cls(**kw)
