"""Token pooling for multi-vector retrieval — PyTorch / CUDA (Hopper) port.

The JAX package (``src/repro``), rewritten for one NVIDIA H100, slice
by slice: ColBERT encode -> token pooling (sequential, k-means or Ward)
-> PLAID 2-bit, HNSW or flat index (add after the build, delete),
monolithic or streamed into capped shards (``ShardedIndex``), or the
pooled two-level cascade, artifacts in the JAX package's format both
ways, and query encode -> device or host probe/prune, or HNSW token
probes -> packed, f32 or dense rerank -> top-k, all behind the
spec-driven ``Retriever`` facade; causal-LM serving (prefill and
decode) of the dense Qwen and the MoE trunks (Moonshot, Kimi K2);
DimeNet with its neighbor sampler; the four recsys models (Wide & Deep,
DeepFM, FM, DLRM); and training: the ColBERT contrastive step, the
causal-LM, DimeNet and recsys train steps, AdamW / Adafactor, the
fault-tolerant ``Trainer`` and checkpoints in the JAX package's format;
the meshes (``DeviceMesh`` with the reference's axis names), the
sharding rules and parameter specs, ``moe_ep``'s expert-parallel
all-to-all, the replicated index's flat plan over a row of devices, and
the (arch x shape) cells' shape-only inputs (``build_cell``), their
dry run on ``meta`` over the production mesh (``run_cell``) and the
roofline on the H100's table (``RooflineTerms``, ``analyse_cell``).
The Pallas kernels on those paths are hand-written CUDA kernels here
(``csrc/``), built with ``nvcc`` at first use.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``::

    import repro_torch as rt

    model = rt.init_colbert(rt.CONFIG, seed=0)
    index, stats = rt.Indexer(model, pooling_spec=rt.PoolingSpec("ward", 2)
                              ).build(doc_tokens, out_dir="idx")
    scores, ids = rt.Searcher.from_dir(model, "idx").search(query_tokens,
                                                            k=10)

    spec = rt.RetrieverSpec(pooling=rt.PoolingSpec("ward", 2),
                            shard=rt.ShardSpec(shard_max_vectors=524_288))
    r = rt.Retriever.build(model, doc_tokens, spec, out_dir="sharded")
    scores, ids = rt.Retriever.load(model, "sharded").search(query_tokens)

    cfg = dataclasses.replace(rt.get_config("qwen3-0.6b"),
                              use_flash_kernel=True)
    lm = rt.init_transformer(cfg, seed=0)
    logits, cache = rt.make_lm_prefill_step(cfg, max_len=S + n)(
        lm, {"tokens": prompts})
    logits, cache = rt.make_lm_decode_step(cfg)(
        lm, cache, {"token": logits.argmax(-1)[:, None], "pos": S})

    trainer = rt.Trainer(lambda m, b: rt.colbert_loss(m, b["q"], b["d"]),
                         model, rt.TrainConfig(total_steps=200,
                                               checkpoint_dir="ckpt"))
    trainer.run(batches)                # {"q": [B, Lq], "d": [B, Ld]} ids

    cfg = rt.get_config("dlrm-rm2")
    rec = rt.init_recsys(cfg, seed=0)
    step, opt = rt.make_recsys_train_step(cfg)
    state, out = step(rec, opt.init(rec), batch)   # sparse_ids, dense, label

Attributes resolve lazily so ``import repro_torch`` stays cheap.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "CONFIG": "repro_torch.configs.colbertv2",
    "JA_CONFIG": "repro_torch.configs.colbertv2",
    "SMOKE": "repro_torch.configs.colbertv2",
    "IndexSpec": "repro_torch.core.spec",
    "PoolingSpec": "repro_torch.core.spec",
    "RetrieverSpec": "repro_torch.core.spec",
    "ShardSpec": "repro_torch.core.spec",
    "ServeSpec": "repro_torch.core.spec",
    "register_pooling_strategy": "repro_torch.core.spec",
    "pooling_methods": "repro_torch.core.spec",
    "register_backend": "repro_torch.core.spec",
    "backend_names": "repro_torch.core.spec",
    "MultiVectorIndex": "repro_torch.core.index",
    "ShardedIndex": "repro_torch.core.sharded",
    "load_artifact": "repro_torch.core.persist",
    "IndexFormatError": "repro_torch.core.persist",
    "Retriever": "repro_torch.api",
    "Indexer": "repro_torch.retrieval.indexer",
    "IndexStats": "repro_torch.retrieval.indexer",
    "EncodedDocs": "repro_torch.retrieval.indexer",
    "Searcher": "repro_torch.retrieval.searcher",
    "CascadeIndex": "repro_torch.retrieval.cascade",
    "ServingEngine": "repro_torch.launch.engine",
    "evaluate_pooling": "repro_torch.retrieval.evaluate",
    "EvalDataset": "repro_torch.eval.datasets",
    "QualitySweep": "repro_torch.eval.sweep",
    "QualityReport": "repro_torch.eval.report",
    "load_beir": "repro_torch.eval.datasets",
    "build_cascade": "repro_torch.retrieval.cascade",
    "ColBERT": "repro_torch.models.colbert",
    "init_colbert": "repro_torch.models.colbert",
    "params_from_jax": "repro_torch.models.colbert",
    "resolve_device": "repro_torch.device",
    "get_config": "repro_torch.configs",
    "get_smoke_config": "repro_torch.configs",
    "TransformerLM": "repro_torch.models.transformer",
    "init_transformer": "repro_torch.models.transformer",
    "make_lm_prefill_step": "repro_torch.launch.steps",
    "make_lm_decode_step": "repro_torch.launch.steps",
    "make_colbert_index_step": "repro_torch.launch.steps",
    "make_colbert_search_step": "repro_torch.launch.steps",
    "make_lm_train_step": "repro_torch.launch.steps",
    "lm_loss": "repro_torch.models.transformer",
    "colbert_loss": "repro_torch.models.colbert",
    "colbert_train_step": "repro_torch.models.colbert",
    "params_to_jax": "repro_torch.models.colbert",
    "make_optimizer": "repro_torch.train",
    "Optimizer": "repro_torch.train",
    "CheckpointManager": "repro_torch.train",
    "Trainer": "repro_torch.train",
    "TrainConfig": "repro_torch.train",
    "DataPipeline": "repro_torch.data.pipeline",
    "lm_batches": "repro_torch.data.pipeline",
    "ALL_ARCHS": "repro_torch.configs",
    "ASSIGNED_ARCHS": "repro_torch.configs",
    "MoE": "repro_torch.models.moe",
    "moe_apply": "repro_torch.models.moe",
    "DimeNet": "repro_torch.models.gnn",
    "init_dimenet": "repro_torch.models.gnn",
    "dimenet_forward": "repro_torch.models.gnn",
    "dimenet_loss": "repro_torch.models.gnn",
    "build_triplets": "repro_torch.models.gnn",
    "NeighborSampler": "repro_torch.models.gnn",
    "Recsys": "repro_torch.models.recsys",
    "init_recsys": "repro_torch.models.recsys",
    "embedding_bag": "repro_torch.models.recsys",
    "recsys_forward": "repro_torch.models.recsys",
    "recsys_loss": "repro_torch.models.recsys",
    "score_candidates": "repro_torch.models.recsys",
    "make_gnn_train_step": "repro_torch.launch.steps",
    "make_recsys_train_step": "repro_torch.launch.steps",
    "make_recsys_serve_step": "repro_torch.launch.steps",
    "make_recsys_retrieval_step": "repro_torch.launch.steps",
    "moe_ep": "repro_torch.models.moe",
    "ReplicatedIndex": "repro_torch.core.replicated",
    "process_group": "repro_torch.launch.mesh",
    "fake_process_group": "repro_torch.launch.mesh",
    "make_mesh": "repro_torch.launch.mesh",
    "make_production_mesh": "repro_torch.launch.mesh",
    "make_host_mesh": "repro_torch.launch.mesh",
    "make_serve_mesh": "repro_torch.launch.mesh",
    "serve_device_table": "repro_torch.launch.mesh",
    "P": "repro_torch.sharding",
    "mesh_context": "repro_torch.sharding",
    "constrain": "repro_torch.sharding",
    "build_cell": "repro_torch.launch.input_specs",
    "all_cells": "repro_torch.launch.input_specs",
    "run_cell": "repro_torch.launch.dryrun",
    "to_placements": "repro_torch.sharding.params",
    "RooflineTerms": "repro_torch.roofline.analysis",
    "TraceCounter": "repro_torch.roofline.analysis",
    "analyse_cell": "repro_torch.roofline.run",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(target), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
