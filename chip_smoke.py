#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; no network
    python3 chip_smoke.py --parent DIR   # also build and time the parent
                                         # commit's plaid_probe,
                                         # maxsim_packed, kmeans_assign and
                                         # all-pairs maxsim (their csrc
                                         # unpacked in DIR, inside this
                                         # checkout)

1. Builds the seven CUDA sources from ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, started together).
2. Drives each path through the user entry points, every kernel's launch
   counter set to 0 just before the path and read just after; a path
   fails unless each of its kernels launched, and where it ran
   ``DocStore.gather`` (the f32 rerank reads its candidates in place):
   * main: full-width ColBERTv2 (random weights from a seed), a
     16,384-doc synthetic corpus, ``Indexer.build(out_dir=...)`` with
     Ward pooling at factor 2 on the default PLAID index (K = 256,
     2 bits, nprobe 8, t_cs 0.3) with ``ndocs`` at 1024, PLAID's own
     k = 100 setting, then ``Searcher.search`` on 64 queries in two
     batches of 32 (k = 10). With random weights each document's vectors
     crowd into one or two centroids, so a query's candidate set is ~6-9%
     of the corpus: under the default ndocs = 8192 the approximate-score
     prune — the ``plaid_probe`` kernel — would never run. The build's
     artifact payloads' sha256 and its device-to-host compaction bytes
     (the per-doc counts alone) are printed; on its first 4 encode
     batches the one-batch-behind loop (``encode_and_pool_counted``)
     must give a serial ``compact_pooled_flat`` loop's rows, counts and
     raw count bit for bit, and ``compact_pooled_finish(
     compact_pooled_begin(...))`` of batch 0 ``compact_pooled_flat``'s
     rows on the host, moving at most 1/2 + 1/64 of the padded bytes;
     after the
     train paths the loop's device idle share over 4,096 docs is
     printed beside docs/s;
   * from_dir: ``Searcher.from_dir`` serves the written artifact; its
     results must equal the in-memory index's exactly;
   * host_probe: the same index with ``probe_kernel="host"``; ids equal
     the device path's tie-aware, scores to 1e-4;
   * dense: a 512-doc plaid index of the corpus's first docs with
     nprobe = K = 256, so every doc is a candidate: the device plan is
     refused and the slate reaches n_docs, so the rerank is the
     all-pairs ``maxsim`` scan;
   * flat: a 4,096-doc flat index (Ward f=2), 64 queries, ``maxsim``;
   * recon_rerank: the 16,384-doc index with ``packed_rerank=False``
     (the ``maxsim_rerank`` kernel reading the candidates from the f32
     reconstruction store in place); results equal the packed path's
     tie-aware, scores to 1e-4;
   * kmeans: a 4,096-doc plaid index pooled by per-document k-means at
     factor 2 (the ``kmeans_assign`` kernel, 11 launches per encode
     batch: 10 Lloyd steps and the final assignment), searched with
     ndocs = 256, PLAID's own k = 10 setting: at 4,096 docs a query's
     candidate set stays under 1024, so only that setting engages the
     prune (``plaid_probe``); each doc stores at most
     n_valid // 2 + 1 vectors;
   * sequential: a 1,024-doc flat index pooled by sequential runs at
     factor 2 (``maxsim``); each doc stores exactly ceil(n_valid / 2);
   * cascade: ``build_cascade`` over 4,096 docs with the reference's
     defaults (Ward, coarse 6, fine 2, 32 candidates), 64 queries
     (``ward_pool``, ``maxsim`` for stage 1, ``maxsim_rerank`` reading
     the fine store in place for stage 2);
   * cascade_from_dir: the cascade saved and served by
     ``Searcher.from_dir``; results equal the in-memory cascade's
     exactly;
   * mutate: the main artifact loaded again by ``Searcher.from_dir``,
     512 of its docs deleted, 1,024 new docs (another corpus seed)
     encoded, Ward-pooled and added, 64 queries: no deleted id comes
     back, the host probe path and the plain versions agree, 16 added
     docs' own vectors find them at top-1, and the index saved
     (compacted) and served again gives equal results; right after
     the add (which drops the packed view) ``device_bytes()`` still
     counts the packed representation;
   * surface: the reference's names on the main path's model, docs and
     index. ``compact_pooled`` of the first pooled batch is bitwise
     ``compact_pooled_finish(compact_pooled_begin(...))`` and
     ``compact_pooled_flat`` split by its counts; ``Indexer(model,
     pool_method="ward", pool_factor=2, backend="plaid", ndocs=16)`` (the
     shorthand, ``ndocs`` a deprecated raw keyword, at which every
     slate prunes) over the first 512 docs resolves the specs of, and
     writes payloads byte-equal to, the spec-built ``Indexer``, and its
     64 queries give bitwise-equal ids and scores (``ward_pool``,
     ``plaid_probe`` and ``maxsim_packed`` counted); the main index's
     ``device_bytes_detail()`` is printed, its ``packed`` equal to the
     bytes of the resident ``padded_packed()`` tensors; ``ward_assign``
     and ``plaid_probe_scores`` with ``impl="kernel"`` are bitwise
     ``"auto"``;
   * hnsw: ``Indexer.build`` of an hnsw index over 128 docs at Ward f=4
     (the graph built in host Python, timed), 16 docs added and 8
     deleted, 32 queries with ``hnsw_candidates`` 1024 (the slate stays
     under n_docs, so ``maxsim_rerank`` reranks it from the store in
     place; a slate of fewer than k docs pads the results); held to the
     plain versions and to the flat backend's exact MaxSim over the same
     slate, then saved and served again by ``Searcher.from_dir`` with
     equal results;
   * plaid_k8192: a plaid index at K = 8,192 over the flat path's stored
     pooled vectors (``add_flat``), nprobe 32, ndocs 16 (random weights
     leave each query few candidates at this K; these cut every query's
     slate): ``"auto"`` takes the host
     path (``doc_member`` is above the gather cap) and
     ``probe_kernel="device"`` the device path; both prune (the
     ``plaid_probe`` kernel reading its table from device memory) and
     agree with each other and with the plain versions;
   * sharding: one rank on the card, the ("data", "model") mesh over
     NCCL (an in-process store): ``ReplicatedIndex.replicate(flat index,
     2, use_shard_map=True)`` over the flat path's 4,096-doc index serves
     each lane through a one-cell flat plan (``maxsim`` counted), bitwise
     equal to ``search_batch``; a forced plan over the same docs in 4
     flat shards falls back to the dispatch merge (its row reuses the
     card), bitwise equal to that index's ``search_batch``; later, after
     the train paths (one call profiled), ``moe_ep`` at
     one Moonshot MoE layer's width on 2,048 tokens takes the
     expert-parallel path under the mesh (one rank: both all-to-alls run
     over NCCL), at a capacity where nothing drops held to ``moe_dense``
     within 2% relative, and timed beside ``moe_capacity``; without a
     context it is ``moe_capacity`` bit for bit;
   * facade: ``Retriever.load`` of the main artifact (run right after
     from_dir): the spec read back from the manifest equals the main
     path's, and its search the main path's results exactly;
   * stream: the 16,384 docs streamed through ``Retriever.build`` with a
     ``ShardSpec`` (shards of at most 524,288 pooled vectors, ~4; the
     flush pipelined, each shard saved, dropped and reloaded) in encode
     batches of 128, then 64 queries fanned out over the shards on the
     probe pool. A shard holds ~5,000 docs, whose candidate sets stay
     under 1024 at random weights (172-470 a query), so the shards take
     ndocs = 256 (as the kmeans path), where ``plaid_probe`` prunes. The buffer's peak,
     the flush's wait and busy seconds and build docs/s are printed;
     results are held tie-aware to the plain versions, the host probe
     path and ``Retriever.load`` of the artifact (which must give back
     the spec); index search is timed with the probe pool at auto and
     at one thread, on the device and the host candidate paths, with
     each shard's probe seconds;
   * stream_parity: the first 4,096 docs streamed into ~4 shards with
     the flush pipelined and serial: every shard payload's sha256, the
     doc ids and the shard bases must be equal; at exhaustive settings
     (nprobe = K = 256, ndocs 4,096: every shard takes the dense
     fallback through ``maxsim``) the sharded search equals a monolithic
     ``Indexer.build`` with the first shard's codec, ids tie-aware
     within 1e-5, the largest score difference printed;
   * examples: the four ``repro_torch.examples`` on the card at their
     own sizes (the SMOKE encoder): quickstart (Ward f=2 against f=1 on
     plaid, nDCG@10), build_and_search on plaid, flat and hnsw (build,
     search, save, load, add, delete), train_colbert (80 ``Trainer``
     steps of 16 pairs, checkpoints, its ``QualitySweep``) and
     multi_arch_smoke (one loss and gradient per assigned
     architecture), each timed; then ``core.maxsim.maxsim_rerank``
     (the gathered route, ``maxsim_rerank_launch``) held against its
     plain version on build_and_search's docs and queries;
   * lm: causal-LM serving of Qwen3-0.6B at full width (28 layers,
     d_model 1024, 16 heads over 8 kv heads, d_head 64, vocab 151,936;
     random weights from a seed; bf16 compute; ``use_flash_kernel``)
     through ``make_lm_prefill_step`` (8 prompts of 2,048 token ids,
     cache of 2,048 + 16) and 16 greedy ``make_lm_decode_step`` calls:
     ``flash_attention`` launches exactly 28 times, once a layer, all in
     the prefill. The same weights and prompts then go through the plain
     path (``use_flash_kernel=False``: ``full_attn`` at S = 2,048): the
     last-token logits, each layer's cache after the first and the
     greedy tokens must agree. A second, uncounted run of the kernel path
     keeps the first and last layer's kernel inputs and outputs, which
     are held against the plain version. Then each fault of
     ``LM_FAULTS`` is planted in the model's kernel call (uncounted
     runs): each must break those limits;
   * lm_long: the same model at B = 1, S = 8,192, prefill only (28 more
     launches), held against the plain path, which at this length is
     the chunked online-softmax path; the first and last layer's kernel
     calls are again held against the plain version.
   * colbert_train: ``examples/train_colbert.py`` at full ColBERTv2
     width (remat, bf16 compute, f32 AdamW): 200 ``Trainer`` steps of 32
     scidocs pairs (docs at the full 254 ids) under the example's
     ``cosine_schedule(3e-3, 10, 200)``, ``max_retries=0``, checkpointed
     at step 100; every parameter's first gradient finite; the loss of
     the last 20 steps below the first 20's; a second ``Trainer`` on
     other weights restores step 100 (the run's final checkpoint
     removed, as after a crash) and runs to 200: parameters bitwise
     equal to the uninterrupted run's. Then ``QualitySweep`` (Ward,
     f = 1-4, plaid 2-bit, ndcg@10 over scifact) with the trained
     encoder (factor-1 cells exactly 100.0), held to the plain versions
     (the Ward kernel tie-aware on the encoder's own docs, each cell's
     search on the same index), and, as readings, at the step-0 weights
     and after the same run at lr 3e-4; the median step ms, pairs/s,
     peak memory and one profiled step printed;
   * lm_train: Qwen3-0.6B at full width (remat, AdamW): the driver
     (``launch.train.run``, what ``main`` runs without ``WORLD_SIZE``)
     for 4 steps of 8 x 2,048 tokens in 2 microbatches, checkpointed,
     then to 6 steps, which must resume at 4; ``make_lm_train_step`` 4
     times on one batch (the loss falls); every gradient finite; remat
     on against off at 2 x 2,048; 2 microbatches of 4 against one batch
     of 8; ``use_flash_kernel`` refused; no kernel launches on either
     train path.
   * train_mesh: the same driver runs over the host mesh of one rank
     (NCCL from an in-process store; the parameters, AdamW's moments
     and each microbatch laid out as DTensors by the reference's
     rules): 4 steps and a checkpoint, then resumed to 6; every loss
     and the final parameters equal lm_train's (bit for bit, else
     within 1e-6 relative); the mesh's step-4 checkpoint restored by
     the driver without a mesh trains the same 2 steps as lm_train's
     resume; step seconds, tokens/s and peak memory beside lm_train's.
   * moe: Moonshot (moonshot-v1-16b-a3b) at full width (d_model 2,048,
     16 heads of 128, 64 experts top 6, moe_d_ff 1,408, vocab 163,840;
     random weights, f32 parameters, bf16 compute), its depth cut to 8
     of 48 layers (28.06B parameters, 112 GB in f32, at 48; 5.24B, 21 GB
     at 8): ``make_lm_prefill_step`` of 8 x 2,048 tokens with
     ``use_flash_kernel`` (exactly 8 ``flash_attention`` launches, one a
     layer at dh 128, none while decoding) and 16 greedy decode steps
     (capacity routing: C from T = B). The plain attention path runs
     twice: with its own routes (route flips, the share of (token, slot)
     assignments whose expert differs, printed per layer beside the
     default capacity's drop share; the logits and cache differences
     are readings: a flipped assignment changes a token's expert output
     outright) and with the kernel path's routes pinned (held to the lm
     path's limits). The first and last layer's own kernel calls are
     held against the plain version and timed (with
     ``scaled_dot_product_attention``) at that shape. One MoE layer on
     2,048 tokens: ``moe_capacity`` at the largest expert's load
     (nothing dropped) against ``moe_dense`` within 2% relative, the
     default capacity's drop share and time. Training at 2 of 48
     layers (1.81B parameters, ~29 GB with f32 AdamW): 4
     ``make_lm_train_step`` calls on one batch of 4 x 2,048 tokens in 4
     microbatches (remat): the loss falls, ``aux`` > 0, every gradient
     group (the router's too) finite and not all zero, two runs from one
     seed bitwise equal. Then (path kimi) a Kimi K2 trunk at full width
     (d_model 7,168, 64 heads of 112 over 8 kv heads, 384 experts top 8,
     moe_d_ff 2,048, vocab 163,840, bf16 parameters), 1 of its 61 layers
     (every layer is a 16.9B-parameter MoE layer, 34 GB; the trunk is
     ~40 GB): a 1 x 2,048 prefill with ``use_flash_kernel`` (exactly one
     ``flash_attention`` launch, at dh 112) and 4 decode steps, held to
     the plain path with the kernel path's routes pinned as Moonshot is,
     the kernel timed at the layer's own q, k, v beside
     ``scaled_dot_product_attention``; its MoE layer on 2,048 tokens,
     capacity against the dense oracle in chunks of 256 tokens;
   * gnn: DimeNet at the published widths (6 blocks, hidden 128,
     bilinear 8, spherical 7, radial 6, cutoff 5, triplet cap 8; bf16
     compute, f32 AdamW) through ``make_gnn_train_step`` on three of the
     reference's ``GNN_SHAPES`` with ``launch/input_specs.py``
     ``GNN_CELL_META``'s tasks: molecule (128 graphs of 30 atoms and 64
     directed edges between lattice neighbours, graph task; 20 steps on
     one batch, the loss falls, two runs bitwise equal), full_graph_sm
     (2,708 nodes, 10,556 edges, 1,433 bag-of-words features, 7
     classes, node task; 5 steps) and minibatch_lg (``NeighborSampler``
     with 1,024 seeds and fanouts 15, 10 over a synthetic
     Reddit-sized graph: 232,965 nodes at in-degree 50, 11.6M edges,
     every node on a jittered 1.5 A lattice and its sources among its
     lattice neighbours (DimeNet's bases blow up as a distance nears 0,
     in both packages, so no two nodes sit closer than 1 A),
     not the cell's 114.6M, since the sampler's budgets of 169,984
     nodes, 168,960 edges and 1.35M triplets do not depend on the
     degree and a host sort of 114.6M edges would eat the time limit;
     602 features, 41 classes; 3 steps, host sampling seconds and
     device step seconds apart). Each cell's first batch through the
     port on the card and on the CPU (f32 compute) within 1e-3
     relative;
   * recsys: wide-deep, deepfm, fm and dlrm-rm2 at their configs (1M
     rows a field; dlrm-rm2's tables 6.66 GB in f32), each freed before
     the next, on the reference's ``RECSYS_SHAPES``: train_batch (3
     AdamW steps on one batch of 65,536 over the full tables, the loss
     falls, two runs bitwise equal), serve_p99 (batch 512, median of 20
     calls; held against the port on the CPU within 0.05), serve_bulk
     (262,144) and retrieval_cand (1 x 1,000,000 candidates, top 100,
     ids equal to a full stable sort's, tie-aware);
   * roofline: ``roofline/hw.py``'s ``HBM_BYTES`` must be the card's
     ``total_memory``; dlrm-rm2's four cells through the dry run
     (``launch/dryrun.py``, on ``meta``) on a one-rank (1, 1) view of
     the production axes, each held to the same step on the card: the
     predicted argument bytes equal the real arguments' exactly, the
     trace's FLOPs equal ``FlopCounterMode``'s count of the card's step,
     and the predicted activation peak and roofline step time print
     beside ``max_memory_allocated`` and the measured step; the packed
     and probe models (``roofline/packed.py``, ``probe.py``) at the main
     path's shapes beside the kernels' times there; and
     ``run_cell("dimenet", "ogb_products")`` over the fake (16, 16)
     group, opened and closed around it, its stage 3 run to its end;
   * sharded: the models' sharding annotations on a one-rank ("data",
     "model") mesh over NCCL, the reference's rules active and the
     parameters laid out by its parameter rules, as the dry run's stage
     3 runs a step: Qwen3-0.6B's prefill (2 x 1,024 tokens, all 28
     layers, the cells' plain attention) and dlrm-rm2's serve step
     (512, the row-sharded gather) each bit for bit the same call with
     no context; ``flash_attention`` handed a DTensor raises with its
     name; then stage 3 at one layer over the fake (16, 16) group for
     one cell of each place it used to stop (the head views and
     residual adds without annotations) and dlrm-rm2 serve_p99
     (``SHARDED_STAGE3``), on this machine's torch: each must run to
     its end, its collective bytes printed.
   The dense, flat, kmeans and cascade paths are re-run with the plain
   versions (``impl="ref"``) and must agree.
3. Holds each kernel against its plain PyTorch version at its path's
   shapes (inputs taken from the built indexes and the k-means path's
   first encode batch; ``ward_pool`` also at N = 512, where its triangle
   lives in device memory, timed there too, and on exact duplicate tokens
   at factors 2, 3, 4 and 6, where it must be equal or tie-equivalent;
   ``plaid_probe`` and ``maxsim_packed`` also at Lq = 300,
   three launches of at most 128 query tokens (``plaid_probe`` also at
   K = 2,048 / Lq = 32, K = 512 / Lq = 128 and 300, K = 16,384 / Lq = 32,
   timed there, at the plaid_k8192 path's own inputs, and both of its
   routes timed against each other at four (K, Lq) where both serve), at
   the main path's own
   inputs (the arguments of one search batch's two calls, captured), on
   uniformly random codes (``plaid_probe``: the index's crowded codes
   take its distinct-code lookups, uniform ones the full read) and at
   b = 4 (``maxsim_packed``, whose SASS must
   hold HMMA instructions: its products run on the tensor cores);
   ``flash_attention`` on
   seeded random inputs in the Qwen3, Qwen1.5, Qwen2.5-14B and Kimi K2
   (dh 112) head layouts, bf16 and f32 (f32 at dh 112 zero-padded to
   128 by the wrapper), Sq < Skv, Sq > Skv, non-causal, the lm_long
   shape, ragged Sq and Skv at dh 128 and 112, and the timed lm shape), and
   times both with CUDA events (behind a sleep kernel, so that host
   dispatch is not counted where the call does not wait on the card);
   prints each kernel's bound (bytes over 3.35 TB/s or operations over
   the f32 peak of 67 TFLOP/s — for ``flash_attention`` the bf16
   tensor-core peak of 989 TFLOP/s, for the products of
   ``maxsim_packed``, ``maxsim`` and ``kmeans_assign`` three passes at
   the TF32 peak of 494.7 TFLOP/s, the f32 bound printed beside — the
   larger). ``maxsim`` is also held and timed at the flat path's own
   inputs (one search batch's arguments, captured) and ``kmeans_assign``
   on random unit vectors at its path's shape; both are timed beside
   ``torch.matmul`` of their product alone (f32, TF32 off; for reference
   only: no port, no library_ms) and their SASS must hold HMMA.
   ``maxsim_rerank`` is held and timed from gathered candidates (one
   slab of the recon store) and read in place at the recon_rerank
   path's own slate and the cascade's stage 2 (both captured from one
   batch); ``dequant_score`` on the main index's candidate rows (its
   SASS must hold HMMA too). With ``--parent``, the earlier checkout's
   C entries (checked against ``PARENT_ABI``) are built, held to the
   same limits and timed on the same inputs: its ``plaid_probe``,
   ``maxsim_packed``, ``kmeans_assign`` and all-pairs ``maxsim`` must
   give this checkout's results bit for bit; its rerank is timed at the
   slates with the gather it needs. One main-path
   ``search_encoded`` batch is traced with ``torch.profiler`` and split
   by its ``search.*`` ranges (centroid scores, ``probe_members`` and
   compaction, the code gather, ``plaid_probe``, the ``stable_topk``
   prune, the packed gather, ``maxsim_packed``, the top-k), with the
   device's idle share over the batch, and so is one recon_rerank batch
   (the same candidate stages, then ``search.maxsim_rerank``).
   ``flash_attention`` is also timed against
   ``scaled_dot_product_attention`` (its
   ``library_ms``; the port never calls it), with its achieved TFLOP/s,
   and its SASS is read with ``cuobjdump -sass``: it fails unless the
   tool is there and the bf16 body issues HMMA (tensor-core)
   instructions.
4. Re-runs the main search with the plain versions (``impl="ref"``): the
   ids must agree tie-aware and the scores to 1e-4. Then the query
   encode at JaColBERTv2's width ([256, 32], ``query_graph_row``): eager
   against ``Searcher.encode_queries``' CUDA graph, with the largest
   difference (fails above ``QG_ATOL``), host and device ms a batch and
   launch calls and kernels a batch for each (fails unless the graph
   makes fewer launch calls).

The line before the last holds ``nvidia-smi``'s card name and power
limit; the one before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing that line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

TF32_PASSES = 3                    # 3xTF32: hi*hi + hi*lo + lo*hi
N_DOCS = 16384
N_QUERIES = 64
QUERY_BATCH = 32
QUERY_LEN = 32                     # ColBERTv2 query_maxlen
TOP_K = 10
NDOCS = 1024                       # PLAID's k=100 setting: engages the prune
SEED = 0
SLEEP_CYCLES = 100_000_000         # ~50 ms: longer than the host queues
SCORE_ATOL = 1e-4                  # f32 sums in another order
DENSE_DOCS = 512
FLAT_DOCS = 4096
KMEANS_DOCS = 4096
KMEANS_NDOCS = 256                 # PLAID's k=10 setting (see the docstring)
SEQUENTIAL_DOCS = 1024
CASCADE_DOCS = 4096
ENCODE_BATCH = 128
COMPACT_BATCHES = 4                # main-build batches held to a serial loop
PROFILE_DOCS = 4096                # the build loop's profiled docs
EXAMPLE_BACKENDS = ("plaid", "flat", "hnsw")
MUTATE_DELETE = 512                # main-index docs deleted on the mutate path
MUTATE_ADD = 1024                  # new docs added there (another corpus seed)
MUTATE_SELF = 16                   # added docs queried by their own vectors
HNSW_DOCS = 128                    # the graph is built in host Python
HNSW_FACTOR = 4
# token hits a query (the reference's default): random weights make a
# query's tokens nearly alike (the path prints their mean cosine), so the
# hits crowd into a few docs and the slate stays under n_docs
HNSW_CANDIDATES = 1024
HNSW_ADD = 16
HNSW_DELETE = 8
STREAM_SHARD_MAX = 524_288         # pooled vectors a shard (~4 shards)
STREAM_NDOCS = 256                 # a ~5,000-doc shard's prune (see stream)
PARITY_DOCS = 4096
PARITY_SHARD_MAX = 131_072         # ~4 shards of the first 4,096 docs
PARITY_ATOL = 1e-5
EVAL_DATASET = "trec-covid"        # DATASET_SPECS: 1,200 docs, 64 queries
EVAL_METHODS = ("ward", "kmeans", "sequential")
EVAL_FACTORS = (1, 2, 3, 4, 6)
EVAL_METRICS = ("ndcg@10", "recall@5", "success@5", "mrr@10")
SERVE_MAX_BATCH = 32
SERVE_THREADS = 4
SERVE_REQUESTS = 512               # 1-8 queries each
SERVE_AFTER_SWAP = 64              # requests served after the swap, at least
SERVE_CLOSED_QUERIES = 256
SERVE_RATE = 400.0                 # open-loop offered QPS
SERVE_OPEN_QUERIES = 512
PACKED_SHAPES = ((256, 129), (768, 129), (128, 12000), (128, 20000))
PACKED_SHAPE_NQ, PACKED_SHAPE_S = 8, 16
PACKED_PATH_MS = 1.2479            # PERF.md: the parent design at the path
K8192 = 8192                       # ColBERT's K rule at ~3.6e5 vectors
# random weights make a query's tokens nearly alike: at K = 8,192 and
# nprobe 8 a query probes few centroids in all and keeps a few candidates
# (the path prints how many); at nprobe 32 every query keeps more than
# ndocs 16, so the prune cuts every slate
K8192_NPROBE = 32
K8192_NDOCS = 16
NEAR_TIE = 1e-5                    # kmeans_assign: top-two sims this close
LONG_LQ = 300                      # a query above the kernels' 128 a launch
LM_ARCH = "qwen3-0.6b"
LM_BATCH = 8
LM_PROMPT = 2048
LM_DECODE = 16
LM_LONG = 8192
# kernel path vs plain path, both bf16 through 28 layers: the attention
# outputs differ by about one bf16 step per layer (the kernel rounds the
# unnormalized p, the plain path the normalized weights), which grows to
# ~2% relative through the depth (measured on the CPU with the plain
# version at 28 layers and d_model 256 / 512: logits 2.1%, cache 1.6%).
# The cache is held layer by layer from the second layer on: layer 0's
# k and v are computed before any attention and do not depend on it.
LM_LOGITS_ATOL = 0.25              # logits: max abs
LM_REL = 0.05                      # logits, each layer's cache: |a-b|/|b|
# faults planted in the kernel path's attention (a wrapper in place of the
# model's kernel call, outside every counted run); each must break one of
# the limits above, else those limits could not see a wrong kernel
LM_FAULTS = ("causal=False", "kv head h % KV, not h // G",
             "diagonal off by one")
# colbert_train: examples/train_colbert.py at full ColBERTv2 width
CT_TRAIN_DATASET = "scidocs"       # the example's training pairs
CT_SWEEP_DATASET = "scifact"       # its sweep: 600 docs, 80 queries
CT_STEPS = 200
CT_BATCH = 32
CT_RESTART = 100                   # the checkpoint a second Trainer resumes
CT_LR = 3e-3                       # cosine_schedule(3e-3, 10, CT_STEPS)
CT_WARMUP = 10
CT_WARM = 10                       # steps left out of the median step time
CT_LOG = 20
CT_LOSS_WINDOW = 20                # the loss must fall: last 20 vs first 20
CT_FACTORS = (1, 2, 3, 4)
# restarted vs uninterrupted parameters: bitwise (every op of a step is
# deterministic; F.embedding's backward sums a row's gradients by sorting)
CT_RESTART_ATOL = 0.0
# ward_pool against its plain version on the encoder's own docs: a doc's
# tokens sit at cosines near 1 (mean 0.965 at step 0, 0.986 trained), so
# squared distances of ~1e-6 carry 2 - 2 cos's f32 rounding (~2^-22),
# merges are picked inside that noise and the two greedy paths part
# (on an H100: 7-13% of docs, objectives up to 3.05% apart). Held as
# ``ward_agree`` does, as many clusters and Ward objectives within:
WARD_OBJ_RTOL = 0.05
CT_READING_LR = 3e-4               # a second run, a reading: 10x lower lr
# lm_train: Qwen3-0.6B at full width
LMT_BATCH = 8
LMT_SEQ = 2048
LMT_MICRO = 2                      # launch.train's --microbatches
LMT_STEPS = 4                      # launch.train run A, then resumed to 6
LMT_RESUME = 6
LMT_B_STEPS = 4                    # make_lm_train_step calls on one batch
LMT_REMAT_BATCH = 2                # remat off keeps 28 layers' scores
# remat on vs off: relative Frobenius, bitwise (the recompute runs the
# same deterministic kernels on the same inputs; equal on an H100)
LMT_REMAT_REL = 0.0
# 2 x 4 vs 1 x 8: each microbatch's weight gradients leave the bf16 GEMMs
# rounded once (on an H100: losses equal to 1e-6, gradients 0.00235
# relative at worst)
LMT_MICRO_LOSS = 1e-3              # loss, max abs
LMT_MICRO_REL = 1e-2               # gradients, relative Frobenius
TMESH_REL = 1e-6                   # train_mesh vs lm_train, if not bitwise
# moe: Moonshot at full width, depth cut to 8 of 48 layers (28.06B
# parameters at 48, 112 GB in its f32 param dtype; 5.24B, 21 GB at 8);
# training at 2 layers (1.81B, ~29 GB with f32 AdamW); one Kimi K2 MoE
# trunk at 1 of 61 layers (16.9B expert parameters, 34 GB in its bf16)
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 8
MOE_BATCH = 8
MOE_PROMPT = 2048
MOE_DECODE = 16
MOE_LAYER_TOKENS = 2048            # one MoE layer: capacity vs dense oracle
# capacity (nothing dropped) against the dense oracle, both bf16: the same
# expert products, summed over k in another order and rounded at other
# places (each output a sum of top_k bf16 terms)
MOE_LAYER_REL = 0.02
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_BATCH = 4                # 4 x 2,048 tokens in 4 microbatches
MOE_TRAIN_STEPS = 4
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_LAYERS = 1                    # each layer 34 GB of bf16 experts
KIMI_BATCH = 1
KIMI_PROMPT = 2048
KIMI_DECODE = 4
KIMI_CHUNK = 256                   # the dense oracle's token chunk
# sharding: one rank; moe_ep at one Moonshot MoE layer's width
EP_TOKENS = 2048
SHARD_PARTS = 4                    # the forced plan's sharded index
# gnn: DimeNet at the published widths on three GNN_SHAPES cells with
# launch/input_specs.py GNN_CELL_META's tasks, classes and features
GNN_STEPS = {"molecule": 20, "full_graph_sm": 5, "minibatch_lg": 3}
GNN_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41}
GNN_MINIBATCH_FEAT = 602
MINIBATCH_DEGREE = 50              # synthetic Reddit: in-degree 50, not 492
# synthetic layouts: a jittered cubic lattice (any two nodes >= 1 A
# apart), edges between lattice neighbours (within DimeNet's 5 A cutoff)
LATTICE_A = 1.5
LATTICE_JITTER = 0.25
# card vs CPU on one batch, f32 compute (TF32 off): six blocks of f32 sums
# in another order, and the j_l recurrence's rounding at small arguments
# (tests/test_torch_gnn.py), relative (Frobenius)
GNN_CPU_REL = 1e-3
# recsys: the four models at their configs on RECSYS_SHAPES
RECSYS_ARCHS = ("wide-deep", "deepfm", "fm", "dlrm-rm2")
RECSYS_TRAIN_STEPS = 3
RECSYS_SERVE_REPS = 20
RECSYS_TOPK = 100
RECSYS_CPU_ATOL = 0.05             # logits, bf16 on both (card vs CPU)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}     # atol = rtol
FLASH_CASES = [  # (what, B, H, KV, Sq, Skv, dh, causal, dtype)
    ("qwen3 16/8/64", 1, 16, 8, 4096, 4096, 64, True, "bfloat16"),
    ("qwen1.5 16/16/64", 1, 16, 16, 4096, 4096, 64, True, "bfloat16"),
    ("qwen2.5-14b 40/8/128", 1, 40, 8, 4096, 4096, 128, True, "bfloat16"),
    ("qwen3 16/8/64 f32", 1, 16, 8, 4096, 4096, 64, True, "float32"),
    ("Sq < Skv", 1, 16, 8, 1000, 4096, 64, True, "bfloat16"),
    ("Sq > Skv", 1, 16, 8, 4096, 1000, 64, True, "bfloat16"),
    ("non-causal", 1, 16, 8, 4096, 4096, 64, False, "bfloat16"),
    ("lm_long 16/8/64", 1, 16, 8, 8192, 8192, 64, True, "bfloat16"),
    ("ragged 40/8/128", 1, 40, 8, 1000, 1333, 128, True, "bfloat16"),
    ("kimi 64/8/112", 1, 64, 8, 2048, 2048, 112, True, "bfloat16"),
    ("kimi 64/8/112 f32", 1, 64, 8, 1000, 1000, 112, True, "float32"),
    ("ragged 16/2/112", 2, 16, 2, 1000, 1333, 112, True, "bfloat16"),
]
ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT_DIR = os.path.join(ROOT, "build", "chip_smoke_index")
CASCADE_DIR = os.path.join(ROOT, "build", "chip_smoke_cascade")
MUTATE_DIR = os.path.join(ROOT, "build", "chip_smoke_mutate")
SURFACE_DIR = os.path.join(ROOT, "build", "chip_smoke_surface")
HNSW_DIR = os.path.join(ROOT, "build", "chip_smoke_hnsw")
STREAM_DIR = os.path.join(ROOT, "build", "chip_smoke_stream")
PARITY_DIR = os.path.join(ROOT, "build", "chip_smoke_parity")
SERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_serve")
CT_DIR = os.path.join(ROOT, "build", "chip_smoke_colbert_train")
LMT_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
TMESH_DIR = os.path.join(ROOT, "build", "chip_smoke_train_mesh")
EXAMPLES_DIR = os.path.join(ROOT, "build", "chip_smoke_examples")
# kernels each path must launch
PATH_KERNELS = {
    "main": ("ward_pool", "plaid_probe", "maxsim_packed"),
    "from_dir": ("plaid_probe", "maxsim_packed"),
    "host_probe": ("plaid_probe", "maxsim_packed"),
    "dense": ("ward_pool", "maxsim"),
    "flat": ("ward_pool", "maxsim"),
    "recon_rerank": ("plaid_probe", "maxsim_rerank"),
    "kmeans": ("kmeans_assign", "plaid_probe", "maxsim_packed"),
    "sequential": ("maxsim",),
    "cascade": ("ward_pool", "maxsim", "maxsim_rerank"),
    "cascade_from_dir": ("maxsim", "maxsim_rerank"),
    "mutate": ("plaid_probe", "maxsim_packed"),
    "surface": ("ward_pool", "plaid_probe", "maxsim_packed"),
    "hnsw": ("ward_pool", "maxsim_rerank"),
    "plaid_k8192": ("plaid_probe", "maxsim_packed"),
    "facade": ("plaid_probe", "maxsim_packed"),
    "stream": ("ward_pool", "plaid_probe", "maxsim_packed"),
    "stream_parity": ("ward_pool", "maxsim"),
    "eval_sweep": ("ward_pool", "kmeans_assign", "maxsim"),
    "eval_main": ("plaid_probe", "maxsim_packed"),
    "serve": ("plaid_probe", "maxsim_packed"),
    "lm": ("flash_attention",),
    "lm_long": ("flash_attention",),
    "colbert_train": ("ward_pool", "maxsim_packed"),   # the sweeps
    "lm_train": (),                    # plain torch: no kernel, no flash
    "moe": ("flash_attention",),       # Moonshot's prefill, at dh 128
    "kimi": ("flash_attention",),      # Kimi K2's prefill, at dh 112
    "sharding": ("maxsim",),           # the one-cell flat plan
    "gnn": (),                         # DimeNet: no kernel in either package
    "recsys": (),                      # none in either package
    "roofline": (),                    # dlrm-rm2 again; the traces on meta
    "sharded": (),                     # the plain paths under a mesh
    "train_mesh": (),                  # lm_train's driver over the mesh
    # the four examples: Ward pooling, plaid's packed rerank, the dense
    # scans of flat, of hnsw's whole-corpus slate and of the sweeps
    # (multi_arch_smoke: autograd, no kernel)
    "examples": ("ward_pool", "maxsim_packed", "maxsim"),
}
PATH_LAUNCHES = {}
MAIN_NUMBERS = {}                  # the main path's build and search times
SURFACE = {}                       # the surface phase's figures
SURFACE_NDOCS = 16                 # every slate of 512 docs prunes here
LMT_RUNS = {}                      # lm_train's driver runs: losses, params
FLASH_ERRS = []                    # flash_attention vs plain, every check
NO_LIBRARY = ("null: no single PyTorch call does the masked max over doc "
              "tokens and the masked sum over query tokens")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    """Mean ms per call on the card: CUDA events around ``reps`` calls
    after one warm-up call. A sleep kernel queued before the first event
    holds the card while the host queues the calls, so a call that does
    not wait on the card is timed by its device work, not by the host's
    dispatch (which varies across machines several-fold); a call that
    does wait is timed as before."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _hw():
    """The card's rates, ``src/repro_torch/roofline/hw.py``: the one
    table every bound here and the port's roofline read."""
    from repro_torch.roofline import hw
    return hw


def _bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = None,
              more=()):
    """The larger of the bytes over the HBM rate and the operations over
    their peak rate (default the f32 peak); ``more``: further
    (operations, rate) pairs of other types, whose times add to the
    first."""
    hw = _hw()
    t_bytes = n_bytes / hw.HBM_BW * 1e3
    t_ops = (n_ops / (ops_per_s or hw.PEAK_FLOPS_F32)
             + sum(o / r for o, r in more)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_path(name, torch, fn):
    """Drive one path with every launch counter at 0 just before it and
    read just after; fails unless each of the path's kernels launched,
    and where a ``DocStore.gather`` ran (the f32 rerank reads its
    candidates from the store in place)."""
    from repro_torch.core.docstore import DocStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gathers = []
    gather = DocStore.gather

    def counted(self, cand):
        gathers.append(tuple(cand.shape))
        return gather(self, cand)

    DocStore.gather = counted
    t0 = time.perf_counter()
    try:
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
    finally:
        DocStore.gather = gather
    launches = launch_counts()
    PATH_LAUNCHES[name] = launches
    print(f"{name} path launches: {launches} "
          f"({time.perf_counter() - t0:.1f} s)")
    missing = [k for k in PATH_KERNELS[name] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {name} path: "
                             f"{missing}")
    if gathers:
        raise AssertionError(f"the {name} path ran DocStore.gather "
                             f"{len(gathers)} times: {gathers}")
    return out


def _search_all(searcher, queries, **kw):
    res = [searcher.search(queries[lo:lo + QUERY_BATCH], k=TOP_K, **kw)
           for lo in range(0, len(queries), QUERY_BATCH)]
    return (np.concatenate([r[0] for r in res]),
            np.concatenate([r[1] for r in res]))


def _agree(what, S, I, S1, I1):
    """Ids equal tie-aware and scores to rtol 1e-5 / atol 1e-4."""
    from repro_torch.core.maxsim import tie_aware_mismatches
    bad = tie_aware_mismatches(I, S, I1, S1, SCORE_ATOL)
    fin = np.isfinite(S) & np.isfinite(S1)      # -inf pads: a short slate
    diff = float(np.abs(S[fin] - S1[fin]).max(initial=0.0))
    print(f"{what}: ids equal {float((I == I1).mean()):.4f}, tie-aware "
          f"mismatches {bad}, max score diff {diff:.3g}")
    if bad or not np.allclose(S, S1, rtol=1e-5, atol=SCORE_ATOL):
        raise AssertionError(f"{what}: results disagree")


def _check_results(S, I, n_docs):
    if S.shape != (N_QUERIES, TOP_K) or I.shape != (N_QUERIES, TOP_K):
        raise AssertionError(f"result shapes {S.shape} {I.shape}")
    if not np.isfinite(S).all():
        raise AssertionError("non-finite scores in the results")
    if not ((I >= 0) & (I < n_docs)).all():
        raise AssertionError("invalid doc ids in the results")


def _steady_search_s(torch, searcher, qv):
    """Seconds of one warm pass of index search over encoded queries."""
    for _ in range(2):
        t0 = time.perf_counter()
        for lo in range(0, len(qv), QUERY_BATCH):
            searcher.search_encoded(qv[lo:lo + QUERY_BATCH], k=TOP_K)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main_path(rt, torch, dev):
    """Build (writing the artifact) and search through the entry points;
    returns what the other paths and the checks need."""
    from repro_torch.core.pooling import compaction_transfer_stats
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus

    cfg = rt.CONFIG
    t0 = time.perf_counter()
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "chip-smoke", n_docs=N_DOCS, n_queries=N_QUERIES, n_topics=64,
        doc_len_mean=200, doc_len_std=40, seed=SEED),
        vocab_size=cfg.trunk.vocab_size)
    docs = corpus.doc_token_batch(cfg.doc_maxlen - 2)
    queries = corpus.query_token_batch(cfg.query_maxlen - 2)
    model = rt.init_colbert(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"setup: corpus {docs.shape} + full-width ColBERTv2 "
          f"({sum(p.numel() for p in model.parameters())} params) in "
          f"{time.perf_counter() - t0:.3f}s")

    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)

    def drive():
        compaction_transfer_stats(reset=True)
        t0 = time.perf_counter()
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=ENCODE_BATCH, device=dev)
        index, stats = indexer.build(docs, out_dir=ARTIFACT_DIR)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        t0 = time.perf_counter()
        S, I = _search_all(searcher, queries)
        torch.cuda.synchronize()
        return index, stats, build_s, searcher, S, I, time.perf_counter() - t0

    index, stats, build_s, searcher, S, I, search_s = run_path(
        "main", torch, drive)
    moved = compaction_transfer_stats(reset=True)
    _candidate_report(torch, index, searcher.encode_queries(queries))
    build_ratio = moved["compact_bytes"] / moved["padded_bytes"]
    print(f"build: {stats.n_docs} docs in {build_s:.3f}s "
          f"({stats.n_docs / build_s:.1f} docs/s); stages (encode and pool "
          f"device seconds) "
          + ", ".join(f"{k} {v:.3f}s" for k, v in stats.stage_seconds.items())
          + f"; device-to-host compaction bytes {moved['compact_bytes']} of "
          f"{moved['padded_bytes']} padded over {moved['batches']} batches "
          f"(ratio {build_ratio:.3g}: the counts alone)")
    print("main artifact payload sha256: " + json.dumps(
        _artifact_digests(ARTIFACT_DIR)))
    host_ratio = check_compaction(rt, torch, model, docs)
    print(f"vectors: raw {stats.n_vectors_raw}, stored "
          f"{stats.n_vectors_stored} (reduction "
          f"{stats.vector_reduction:.4f}); device bytes {stats.device_bytes}")
    if stats.n_vectors_stored > stats.n_vectors_raw / 2 + stats.n_docs:
        raise AssertionError("Ward f=2 stored more than raw/2 + n_docs")
    _check_results(S, I, stats.n_docs)

    # steady state: the same two batches again, stage by stage
    t_enc = t_search = 0.0
    for lo in range(0, N_QUERIES, QUERY_BATCH):
        t0 = time.perf_counter()
        qv = searcher.encode_queries(queries[lo:lo + QUERY_BATCH])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        searcher.search_encoded(qv, k=TOP_K)
        torch.cuda.synchronize()
        t_enc += t1 - t0
        t_search += time.perf_counter() - t1
    print(f"search: {N_QUERIES} queries first pass {search_s:.3f}s; steady "
          f"{N_QUERIES / (t_enc + t_search):.1f} QPS (encode {t_enc:.4f}s, "
          f"index search {t_search:.4f}s)")
    MAIN_NUMBERS.update(build_docs_s=stats.n_docs / build_s,
                        index_search_s=t_search,
                        stage_seconds=dict(stats.stage_seconds),
                        build_transfer_ratio=build_ratio,
                        host_transfer_ratio=host_ratio)
    qrels = [dict(q) for q in corpus.qrels]
    return index, stats, model, docs, searcher, queries, qrels, S, I


def _artifact_digests(root):
    """{payload name: sha256 of its .npy bytes} of a monolithic artifact."""
    import hashlib
    from repro_torch.core.persist import read_manifest
    out = {}
    for name, p in sorted(read_manifest(root)["payloads"].items()):
        with open(os.path.join(root, p["file"]), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def check_compaction(rt, torch, model, docs):
    """The main build's first ``COMPACT_BATCHES`` encode batches: the
    pipelined loop (``encode_and_pool_counted``) gives the rows, per-doc
    counts and raw count of a serial loop that compacts each batch with
    ``compact_pooled_flat``, bit for bit; on the first batch,
    ``compact_pooled_finish(compact_pooled_begin(...))`` gives
    ``compact_pooled_flat``'s rows moved to the host, bit for bit, and
    moves at most 1/2 + 1/64 of the padded bytes (Ward f=2). -> that
    ratio."""
    from repro_torch.core.pooling import (compact_pooled_begin,
                                          compact_pooled_finish,
                                          compact_pooled_flat,
                                          compaction_transfer_stats)
    from repro_torch.models.colbert import encode_docs
    indexer = rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                         pooling_spec=rt.PoolingSpec("ward", 2),
                         encode_batch=ENCODE_BATCH, device=model.device)
    sub = docs[:COMPACT_BATCHES * ENCODE_BATCH]
    flat, counts, raw = indexer.encode_and_pool_counted(sub)
    rows, cnts, raw_s, first = [], [], 0, None
    for lo in range(0, len(sub), ENCODE_BATCH):
        v, emit = encode_docs(model, sub[lo:lo + ENCODE_BATCH])
        pooled, pmask = indexer.pooling.apply(v, emit)
        f, c = compact_pooled_flat(pooled, pmask)
        rows.append(f)
        cnts.append(c)
        raw_s += int(emit.sum())
        first = first or (pooled, pmask, f, c)
    if not (torch.equal(flat, torch.cat(rows)) and raw == raw_s
            and np.array_equal(counts, torch.cat(cnts).cpu().numpy())):
        raise AssertionError("the pipelined build loop differs from the "
                             "serial compact_pooled_flat loop")
    pooled, pmask, f, c = first
    compaction_transfer_stats(reset=True)
    got = compact_pooled_finish(compact_pooled_begin(pooled, pmask))
    moved = compaction_transfer_stats(reset=True)
    want = np.split(f.cpu().numpy(), np.cumsum(c.cpu().numpy()[:-1]))
    if len(got) != len(want) or not all(
            g.dtype == w.dtype and np.array_equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError("compact_pooled_finish(begin) differs from "
                             "compact_pooled_flat on the host")
    ratio = moved["compact_bytes"] / moved["padded_bytes"]
    print(f"compaction: {COMPACT_BATCHES} pipelined batches bitwise equal "
          f"to the serial compact_pooled_flat loop ({len(flat)} rows, raw "
          f"{raw}); finish(begin) of batch 0 bitwise compact_pooled_flat's "
          f"rows "
          f"on the host, moving {moved['compact_bytes']} of "
          f"{moved['padded_bytes']} padded bytes (ratio {ratio:.4f})")
    if ratio > 1 / 2 + 1 / 64:
        raise AssertionError(f"compaction moved {ratio:.4f} of the padded "
                             f"bytes at Ward f=2")
    return ratio


def build_loop_profile(rt, torch, model, docs, card):
    """The main build's loop (``encode_and_pool_counted``) over the first
    ``PROFILE_DOCS`` docs under the profiler: its device idle share."""
    indexer = rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                         pooling_spec=rt.PoolingSpec("ward", 2),
                         encode_batch=ENCODE_BATCH, device=model.device)
    sub = docs[:PROFILE_DOCS]
    out = _profile_step(torch, f"main build loop ({PROFILE_DOCS} docs)",
                        lambda: indexer.encode_and_pool_counted(sub),
                        host_ops=False)
    MAIN_NUMBERS.update(build_loop=out)
    print(f"main build: {MAIN_NUMBERS['build_docs_s']:.1f} docs/s, stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in
                      MAIN_NUMBERS["stage_seconds"].items())
          + ", compaction transfer ratio "
          f"{MAIN_NUMBERS['build_transfer_ratio']:.3g} (host finish of one "
          f"batch {MAIN_NUMBERS['host_transfer_ratio']:.4f}), build loop idle "
          f"share {out['idle_share']:.4f} [{card}]")
    return out


def examples_path(rt, torch, dev, card):
    """The four examples (``repro_torch.examples``) on the card at their
    own sizes, as a user runs them: quickstart, build_and_search on
    plaid, flat and hnsw, train_colbert (80 steps of 16, its sweep) and
    multi_arch_smoke; then ``core.maxsim.maxsim_rerank`` (the gathered
    route) held against its plain version at build_and_search's
    shapes."""
    from repro_torch.core.maxsim import maxsim_rerank
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    from repro_torch.examples import (build_and_search, multi_arch_smoke,
                                      quickstart, train_colbert)
    from repro_torch.models.colbert import encode_queries
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def drive():
        out = {"quickstart": timed("quickstart", lambda: quickstart.main([]))}
        for b in EXAMPLE_BACKENDS:
            out[b] = timed(f"build_and_search {b}", lambda: (
                build_and_search.main(["--backend", b])))
        out["train"] = timed("train_colbert", lambda: train_colbert.main(
            ["--checkpoint-dir", EXAMPLES_DIR]))
        out["archs"] = timed("multi_arch_smoke",
                             lambda: multi_arch_smoke.main([]))
        return out

    t0 = time.perf_counter()
    out = run_path("examples", torch, drive)
    total = time.perf_counter() - t0
    q = out["quickstart"]
    if not (q["rows"]["ward f=2"]["vectors"] < q["rows"]["unpooled"][
            "vectors"] and 0.4 < q["vector_reduction"] < 0.55
            and all(np.isfinite(r["ndcg@10"]) for r in q["rows"].values())):
        raise AssertionError(f"quickstart: {q}")
    for b in EXAMPLE_BACKENDS:
        r = out[b]
        if (r["n_docs"] != 100 or r["added"] != [100, 119]
                or r["victim"] in r["after_delete"][1][0].tolist()
                or not np.isfinite(r["initial"][0]).all()):
            raise AssertionError(f"build_and_search {b}: {r}")
    t = out["train"]
    losses = [h["loss"] for h in t["history"]]
    f1 = [c for c in t["report"]["cells"] if c["factor"] == 1]
    if (t["final_step"] != 80 or not np.isfinite(losses).all()
            or not f1 or f1[0]["relative"]["ndcg@10"] != 100.0):
        raise AssertionError(f"train_colbert: {t['final_step']} {losses}")
    if not np.isfinite(list(out["archs"].values())).all():
        raise AssertionError(f"multi_arch_smoke: {out['archs']}")

    # maxsim_rerank's gathered route at build_and_search's shapes
    model = rt.init_colbert(rt.get_smoke_config("colbertv2"), seed=SEED,
                            device=dev)
    cfg = model.cfg
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "crud-demo", n_docs=120, n_queries=16, n_topics=6, doc_len_mean=36,
        doc_len_std=6, seed=11), vocab_size=cfg.trunk.vocab_size)
    idx = rt.Indexer(model, pooling_spec=rt.PoolingSpec("ward", 2),
                     device=dev)
    per_doc = idx.encode_and_pool(corpus.doc_token_batch(cfg.doc_maxlen - 2))
    d = torch.nn.utils.rnn.pad_sequence(per_doc, batch_first=True)
    dm = torch.nn.utils.rnn.pad_sequence(
        [torch.ones(len(v), dtype=torch.bool, device=dev) for v in per_doc],
        batch_first=True)
    qv, qm = encode_queries(model, corpus.query_token_batch(
        cfg.query_maxlen - 2))
    S = 32
    cand = (torch.arange(S, device=dev)[None] * 3
            + torch.arange(len(qv), device=dev)[:, None] * 7) % len(per_doc)
    got = maxsim_rerank(qv, qm, d[cand], dm[cand])
    want = maxsim_rerank(qv, qm, d[cand], dm[cand], impl="ref")
    err = _hold("examples maxsim_rerank (gathered)", torch, got, want, [])
    print("examples: " + ", ".join(f"{k} {v:.3f}s" for k, v in
                                   seconds.items())
          + f"; path {total:.3f}s; core.maxsim.maxsim_rerank [{len(qv)}, "
          f"{S}] max abs err {err:.3g} vs its plain version [{card}]")
    return dict(seconds=seconds, total_s=total,
                launches=PATH_LAUNCHES["examples"], rerank_max_abs_err=err)


def _candidate_report(torch, index, qv):
    """Per-query candidate counts of stage 2 (the prune engages when a
    batch's largest count pads past ``ndocs``), printed and returned."""
    from repro_torch.core.plaid import _centroid_scores_batch, probe_members
    p = index._plaid
    div = p.device_ivf()
    cs = _centroid_scores_batch(qv, p.codec.centroids)
    qm = torch.ones(qv.shape[:2], dtype=torch.bool, device=qv.device)
    live = torch.ones(p.n_docs, dtype=torch.bool, device=qv.device)
    member, counts = probe_members(cs, qm, div.doc_member, live,
                                   min(index.nprobe, p.codec.n_centroids))
    c = counts.float()
    owners = div.doc_member.sum(dim=1)
    print(f"candidates per query: min {int(c.min())} median "
          f"{float(c.median()):.0f} max {int(c.max())} of {p.n_docs} docs "
          f"(ndocs {index.ndocs}); docs per centroid: median "
          f"{float(owners.median()):.0f} max {int(owners.max())}")
    return counts


def _ward_inputs(torch, dev, B, N, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, N, d), generator=g, device=dev)
    n_valid = torch.randint(N // 2, N + 1, (B,), generator=g, device=dev)
    mask = torch.arange(N, device=dev)[None, :] < n_valid[:, None]
    return x, mask


def check_ward(torch, dev):
    """At the build's shape (B = 64, N = 256, d = 128) and at N = 512 (a
    doc_maxlen of 512: above 330 tokens the kernel keeps the distance
    triangle in device memory), assignments equal the plain version's in
    every document; on exact duplicate tokens (ties) at factors 2, 3, 4,
    6 they are equal or tie-equivalent (``ward_agree``: as many clusters,
    Ward objectives within 1e-5; the kernel's duplicates are exactly 0
    apart, the plain version's nearly so). Timed at both N."""
    from repro_torch.core.ward import ward_targets
    from repro_torch.kernels.ward_pool.ops import ward_assign
    from repro_torch.kernels.ward_pool.ref import ward_agree
    B, N, d, f = 64, 256, 128, 2
    x, mask = _ward_inputs(torch, dev, B, N, d, SEED)
    x512, mask512 = _ward_inputs(torch, dev, B, 512, d, SEED + 1)
    checked = []
    for what, xs, ms, fs in [("build shape", x, mask, f),
                             ("N=512", x512, mask512, f)] + [
            (f"duplicates f={t}", *_ward_ties(torch, dev, N, d, t), t)
            for t in (2, 3, 4, 6)]:
        got = ward_assign(xs, ms, fs)
        want = ward_assign(xs, ms, fs, impl="ref")
        torch.cuda.synchronize()
        equal = int((got == want).all(dim=1).sum())
        ties = what.startswith("duplicates")
        bad = int((~ward_agree(xs, ms, got, want)).sum()) if ties else (
            xs.shape[0] - equal)
        n = xs.shape[1]
        print(f"ward_pool {what} (B={xs.shape[0]}, N={n}): {equal} docs "
              f"equal to the plain version, {bad} "
              f"{'not tie-equivalent' if ties else 'differ'}")
        if bad:
            raise AssertionError(f"ward_pool {what}: {bad} docs disagree "
                                 f"with the plain version")
        checked.append(f"{what} (B={xs.shape[0]}, N={n}): {equal} equal"
                       + (", the rest tie-equivalent" if ties else ""))
    _, steps = ward_targets(mask, f)
    n_steps = int(steps.sum())
    P = N * (N - 1) // 2
    # the distances (upper triangle and norms, 2 d each) and, per merge,
    # an O(N) argmin and Lance-Williams row update (~12 operations a token)
    ops = B * (P + N) * d * 2 + n_steps * 12 * N
    bound, by = _bound_ms(_nbytes(x, mask) + B * N * 4, ops)
    ms512 = _time_ms(lambda: ward_assign(x512, mask512, f))
    print(f"ward_pool at B={B}, N=512, d={d}: {ms512:.4f} ms")
    return dict(name="ward_pool", route="cuda",
                source="src/repro_torch/csrc/ward_pool.cu",
                replaces="src/repro/kernels/ward_pool/kernel.py:63",
                **_launches("ward_pool"), max_abs_err=0.0,
                ms=_time_ms(lambda: ward_assign(x, mask, f)),
                plain_ms=_time_ms(lambda: ward_assign(x, mask, f, impl="ref"),
                                  reps=1),
                bound_ms=bound, bound_by=by, library_ms=None,
                check=f"{'; '.join(checked)}; timed at B={B}, N={N}, d={d}, "
                      f"f={f}; at N=512 {ms512:.4f} ms")


def _ward_ties(torch, dev, N, d, factor):
    """Docs whose tokens are each repeated ``factor`` times, shuffled (exact
    duplicates: zero-distance ties); one half-padded doc, one all-pad."""
    g = torch.Generator(device=dev).manual_seed(SEED + factor)
    B, n = 8, N // factor
    base = torch.randn((B, n, d), generator=g, device=dev)
    x = base.repeat(1, factor, 1)[:, torch.randperm(n * factor, generator=g,
                                                    device=dev)]
    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
    mask[1, n * factor // 2:] = False
    mask[2] = False
    return x, mask


def _hold(what, torch, got, want, err_list):
    """-inf slots equal and finite values to rtol 1e-5 / atol SCORE_ATOL;
    appends the max abs error of the finite values."""
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    err_list.append(err)
    if not (torch.equal(torch.isinf(got), torch.isinf(want)) and
            torch.allclose(got[fin], want[fin], rtol=1e-5, atol=SCORE_ATOL)):
        raise AssertionError(f"{what}: disagrees with the plain version "
                             f"(max abs err {err})")
    return err


def _probe_bound(q, qm, cen, codes, cmask, vmask):
    """Bytes: the query, centroids and slot flags, the codes and masks of
    the valid slots only, the scores; operations: the [Lq, K] table a
    query and a lookup and a max per valid token and query token."""
    Nq, Lq, dim = q.shape
    K = cen.shape[0]
    L = codes.shape[2]
    n_valid = int(vmask.sum())
    n_bytes = (_nbytes(q, qm, cen, vmask) + n_valid * L * 5
               + vmask.numel() * 4)
    ops = Nq * Lq * K * dim * 2 + int(cmask.sum()) * Lq * 2
    return _bound_ms(n_bytes, ops)


def _crowded_share(codes, cmask, vmask):
    """Share of the valid slots on which ``plaid_probe`` takes its
    distinct-code lookups: the first 32 tokens repeat their first code
    (a masked token counting as one more code) in more than a quarter of
    places."""
    n = min(32, codes.shape[2])
    first = codes[..., :n].masked_fill(~cmask[..., :n], -1)
    crowded = 4 * (first == first[..., :1]).sum(-1) > n
    return float(crowded[vmask].float().mean())


def check_plaid_probe(torch, dev, index, qv, path_args, k8192_args, parent):
    """At the synthetic shape (each query scores every doc of the corpus,
    9 in 10 slots valid, the index's own codes), on uniformly random codes
    at that shape, at the main path's own inputs (``path_args``), at the
    plaid_k8192 path's (``k8192_args``: K = 8,192, the table in device
    memory) and at Lq = 300; timed beside the parent design where
    ``parent`` holds it."""
    from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores
    p = index._plaid
    codes, tok_mask = p.padded_codes()
    Nq, Lq, _ = qv.shape
    C = p.n_docs
    t_cs = index.t_cs
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cand = torch.stack([torch.randperm(C, generator=g, device=dev)
                        for _ in range(Nq)])
    cmask = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False                       # masked query tokens too
    gcodes = codes[cand]
    gmask = tok_mask[cand] & cmask[:, :, None]
    cen = p.codec.centroids.contiguous()
    K, dim = cen.shape
    L = gcodes.shape[2]
    ucodes = torch.randint(0, K, gcodes.shape, generator=g, device=dev,
                           dtype=torch.int32)
    cases = {"synthetic": (qv, qm, cen, gcodes, gmask, cmask),
             "uniform": (qv, qm, cen, ucodes, gmask, cmask),
             "path": path_args, "k8192 path": k8192_args}
    errs = []

    def run(args, impl="auto"):
        return plaid_probe_scores(*args, t_cs=t_cs, impl=impl)

    times = {}
    for what, args in cases.items():
        _hold(f"plaid_probe {what}", torch, run(args), run(args, "ref"), errs)
        times[what] = _time_ms(lambda: run(args))
        if parent and what != "k8192 path":     # past the parent's K
            got = parent["plaid_probe"](*args, t_cs)
            if not torch.equal(got, run(args)):
                raise AssertionError(f"plaid_probe {what}: differs from the "
                                     f"parent design's scores")
            times[what + " parent"] = _time_ms(
                lambda: parent["plaid_probe"](*args, t_cs))
    # a long query (Lq = 300): three launches of at most 128 tokens, summed
    q_long, qm_long = _long_queries(torch, dev, Nq, qv.shape[2], SEED + 5)
    long_args = (q_long, qm_long, cen, gcodes, gmask, cmask)
    long_err = _hold(f"plaid_probe at Lq={LONG_LQ}", torch, run(long_args),
                     run(long_args, "ref"), errs)
    print(f"plaid_probe at Lq={LONG_LQ}: max abs err {long_err:.3g}")
    large = _probe_large_k(torch, dev, dim, t_cs, errs)
    plain_ms = _time_ms(lambda: run(cases["synthetic"], "ref"), reps=2)
    path_plain_ms = _time_ms(lambda: run(path_args, "ref"), reps=2)
    bound, by = _probe_bound(*cases["synthetic"])
    path_bound, path_by = _probe_bound(*path_args)
    pc, pm, pv = path_args[3:]
    print(f"plaid_probe path inputs: Nq={pc.shape[0]} x C={pc.shape[1]} "
          f"slots, {int(pv.sum())} valid, L={pc.shape[2]}; bound "
          f"{path_bound:.4f} ms ({path_by}), plain {path_plain_ms:.4f} ms")
    k8192_plain_ms = _time_ms(lambda: run(k8192_args, "ref"), reps=2)
    k8192_bound, k8192_by = _probe_bound(*k8192_args)
    kc, km, kv = k8192_args[3:]
    print(f"plaid_probe k8192 path inputs: K={k8192_args[2].shape[0]}, "
          f"Nq={kc.shape[0]} x C={kc.shape[1]} slots, {int(kv.sum())} "
          f"valid, L={kc.shape[2]}; {times['k8192 path']:.4f} ms, bound "
          f"{k8192_bound:.4f} ms ({k8192_by}), plain {k8192_plain_ms:.4f} ms")
    print("plaid_probe times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    print("plaid_probe share of valid slots taking the distinct-code "
          "lookups: " + ", ".join(f"{k} {_crowded_share(*a[3:]):.4f}"
                                  for k, a in cases.items()))
    return dict(name="plaid_probe", route="cuda",
                source="src/repro_torch/csrc/plaid_probe.cu",
                replaces="src/repro/kernels/plaid_probe/kernel.py:62",
                **_launches("plaid_probe"), max_abs_err=max(errs),
                ms=times["synthetic"], plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, path_ms=times["path"],
                path_plain_ms=path_plain_ms, path_bound_ms=path_bound,
                parent_ms=times.get("synthetic parent"),
                parent_path_ms=times.get("path parent"), times_ms=times,
                k8192_path_ms=times["k8192 path"],
                k8192_path_plain_ms=k8192_plain_ms,
                k8192_path_bound_ms=k8192_bound, **large,
                check=f"-inf slots equal, finite allclose rtol 1e-5 atol "
                      f"{SCORE_ATOL} (synthetic Nq={Nq}, Lq={Lq}, C={C}, "
                      f"L={L}, K={K}; uniformly random codes; the main "
                      f"and plaid_k8192 paths' own inputs"
                      f"{'; equal to the parent design' if parent else ''};"
                      f" and at Lq={LONG_LQ}, three launches of two "
                      f"kernels; at K = 2,048 / Lq = 32, K = 512 / Lq = 128 "
                      f"and {LONG_LQ}, K = 16,384 / Lq = 32, and both routes "
                      f"where both serve); bound: valid slots' bytes, f32 "
                      f"rate")


# (K, Lq) cases of plaid_probe past the main path's K = 256, where the
# table of 128 query tokens a launch outgrows shared memory
PROBE_LARGE_K = ((2048, 32), (512, 128), (512, LONG_LQ), (16384, 32))
# (K, Lq, chunk) where both routes serve, timed against each other: the
# table in shared memory at the widest query chunk it fits, or in device
# memory at 128 query tokens a launch
PROBE_ROUTES_AT = ((256, 32, 128), (512, 128, 96), (700, 128, 64),
                   (1024, 128, 32))
PROBE_LARGE_C = 4096


def _probe_large_k(torch, dev, dim, t_cs, errs):
    """``plaid_probe`` on random unit centroids and uniformly random codes
    (Nq = 32, C = 4,096 slots, 90% valid, L = 129) at each of
    ``PROBE_LARGE_K``, held to the plain version; the K = 16,384 case
    timed with its bound; at each of ``PROBE_ROUTES_AT`` both routes held
    and timed. -> the kernels-line keys."""
    from repro_torch.kernels.plaid_probe.ops import (_load, plaid_probe_scores,
                                                     probe_route)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    Nq, C, L = 32, PROBE_LARGE_C, 129
    cmask = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    tmask = (torch.rand((Nq, C, L), generator=g, device=dev) < 0.8) & \
        cmask[:, :, None]

    def inputs(K, Lq):
        q = torch.randn((Nq, Lq, dim), generator=g, device=dev)
        cen = torch.randn((K, dim), generator=g, device=dev)
        codes = torch.randint(0, K, (Nq, C, L), generator=g, device=dev,
                              dtype=torch.int32)
        qm = torch.rand((Nq, Lq), generator=g, device=dev) > 0.05
        return (q / q.norm(dim=-1, keepdim=True), qm,
                cen / cen.norm(dim=-1, keepdim=True), codes, tmask, cmask)

    smem = _load().plaid_probe_smem_bytes
    out = {}
    for K, Lq in PROBE_LARGE_K:
        args = inputs(K, Lq)
        route = probe_route(Lq, K, dim, smem)
        err = _hold(f"plaid_probe K={K} Lq={Lq} route {route}", torch,
                    plaid_probe_scores(*args, t_cs=t_cs),
                    plaid_probe_scores(*args, t_cs=t_cs, impl="ref"), errs)
        print(f"plaid_probe K={K}, Lq={Lq}: route {route}, max abs err "
              f"{err:.3g}")
        if K == 16384:
            ms = _time_ms(lambda: plaid_probe_scores(*args, t_cs=t_cs))
            plain = _time_ms(lambda: plaid_probe_scores(*args, t_cs=t_cs,
                                                        impl="ref"), reps=2)
            bound, by = _probe_bound(*args)
            out.update(k16384_ms=ms, k16384_plain_ms=plain,
                       k16384_bound_ms=bound, k16384_bound_by=by)
            print(f"plaid_probe K=16384, Lq=32 (Nq={Nq}, C={C}, L={L}): "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({by})")
    route_ms = {}
    for K, Lq, width in PROBE_ROUTES_AT:
        args = inputs(K, Lq)
        want = plaid_probe_scores(*args, t_cs=t_cs, impl="ref")
        times = {}
        for route, chunk in (("smem", width), ("global", 128)):
            _hold(f"plaid_probe K={K} Lq={Lq} route {route}", torch,
                  plaid_probe_scores(*args, t_cs=t_cs, route=route,
                                     chunk=chunk), want, errs)
            times[f"{route} {chunk}"] = _time_ms(
                lambda: plaid_probe_scores(*args, t_cs=t_cs, route=route,
                                           chunk=chunk))
        bound, by = _probe_bound(*args)
        route_ms[f"K={K} Lq={Lq}"] = dict(times, bound=bound)
        print(f"plaid_probe K={K}, Lq={Lq} (Nq={Nq}, C={C}, L={L}): the "
              f"rule takes {probe_route(Lq, K, dim, smem)}; " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; bound {bound:.4f} ms ({by})")
    out.update(route_ms=route_ms)
    return out


def _packed_bound(q, qm, w, a, dm, cen, vals):
    """Bytes: the query, the token masks, the words and ids of the valid
    tokens only, the codec, the scores; operations: per valid query and
    doc token 2 dim at 3xTF32 (three passes at the TF32 tensor-core
    rate), and the reconstruction's 4 dim per valid doc token at f32."""
    Nq, Lq, dim = q.shape
    W = w.shape[-1]
    n_tok = int(dm.sum())
    pairs = int((qm.sum(1) * dm.flatten(1).sum(1)).sum())
    n_bytes = (_nbytes(q, qm, dm, cen, vals) + n_tok * (4 * W + 4)
               + dm.shape[0] * dm.shape[1] * 4)
    return _bound_ms(n_bytes, n_tok * dim * 4, _hw().PEAK_FLOPS_F32,
                     more=[(pairs * dim * 2 * TF32_PASSES,
                            _hw().PEAK_FLOPS_TF32)])


def check_maxsim_packed(torch, dev, index, qv, path_args, parent):
    """At the synthetic shape (S = 1,024 random docs of the index a query,
    19 in 20 valid) at b = 2 (the index's codes) and b = 4 (random
    codes), at the main path's own inputs (``path_args``) and at
    Lq = 300; timed beside the parent design where ``parent`` holds it.
    Fails unless the built library issues HMMA (tensor-core) instructions."""
    from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
    p = index._plaid
    ids, words, tmask = p.padded_packed()
    Nq, Lq, dim = qv.shape
    S = 1024
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    cand = torch.randint(0, p.n_docs, (Nq, S), generator=g, device=dev)
    cm = torch.rand((Nq, S), generator=g, device=dev) < 0.95
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    cases, errs, times = {}, [], {}
    for bits in (2, 4):
        if bits == p.codec.bits:
            w, cen, vals = words[cand], p.codec.centroids, p.codec.values
        else:                                # random codes of the other width
            W = dim * bits // 32
            w = torch.randint(-2 ** 31, 2 ** 31 - 1, (Nq, S, ids.shape[1], W),
                              generator=g, device=dev, dtype=torch.int32)
            cen = p.codec.centroids
            vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.05
        cases[f"b={bits}"] = ((qv, qm, w, ids[cand], tmask[cand] & cm[:, :, None],
                               cen.contiguous(), vals.contiguous()), bits)
    cases["path"] = (path_args, p.codec.bits)

    def run(args, bits, impl="auto"):
        return maxsim_packed_rerank(*args, bits=bits, impl=impl)

    for what, (args, bits) in cases.items():
        _hold(f"maxsim_packed {what}", torch, run(args, bits),
              run(args, bits, "ref"), errs)
        times[what] = _time_ms(lambda: run(args, bits))
        if parent:
            got = parent["maxsim_packed"](*args, bits)
            if not torch.equal(got, run(args, bits)):
                raise AssertionError(f"maxsim_packed {what}: differs from "
                                     f"the parent design's scores")
            times[what + " parent"] = _time_ms(
                lambda: parent["maxsim_packed"](*args, bits))
    # a long query (Lq = 300): three launches of at most 128 tokens, summed
    q_long, qm_long = _long_queries(torch, dev, Nq, dim, SEED + 6)
    c_long = cand[:, :256]            # the plain version holds [.., Lq, Ld]
    long_args = (q_long, qm_long, words[c_long], ids[c_long],
                 tmask[c_long] & cm[:, :256, None],
                 p.codec.centroids.contiguous(), p.codec.values.contiguous())
    long_err = _hold(f"maxsim_packed at Lq={LONG_LQ}", torch,
                     run(long_args, p.codec.bits),
                     run(long_args, p.codec.bits, "ref"), errs)
    print(f"maxsim_packed at Lq={LONG_LQ}: max abs err {long_err:.3g}")
    shapes = _packed_shapes(torch, dev, run, errs)
    syn, bits = cases[f"b={p.codec.bits}"]
    plain_ms = _time_ms(lambda: run(syn, bits, "ref"), reps=2)
    path_plain_ms = _time_ms(lambda: run(path_args, bits, "ref"), reps=2)
    bound, by = _packed_bound(*syn)
    path_bound, path_by = _packed_bound(*path_args)
    pdm = path_args[4]
    print(f"maxsim_packed path inputs: Nq={pdm.shape[0]}, S={pdm.shape[1]}, "
          f"Ld={pdm.shape[2]}, {int(pdm.any(2).sum())} candidates with a "
          f"valid token, {int(pdm.sum())} valid tokens; bound "
          f"{path_bound:.4f} ms ({path_by}), plain {path_plain_ms:.4f} ms")
    print("maxsim_packed times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f"; path "
        f"{times['path'] / PACKED_PATH_MS:.4f}x the parent design's "
        f"{PACKED_PATH_MS} ms (PERF.md); {_hmma_count('maxsim_packed')}")
    return dict(name="maxsim_packed", route="cuda",
                source="src/repro_torch/csrc/maxsim_packed.cu",
                replaces="src/repro/kernels/maxsim_packed/kernel.py:66",
                **_launches("maxsim_packed"), max_abs_err=max(errs),
                ms=times[f"b={bits}"], plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, path_ms=times["path"],
                path_plain_ms=path_plain_ms, path_bound_ms=path_bound,
                parent_ms=times.get(f"b={bits} parent"),
                parent_path_ms=times.get("path parent"), times_ms=times,
                shapes=shapes,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL} at b=2 and b=4 "
                      f"(Nq={Nq}, S={S}, Ld={ids.shape[1]}), at the main "
                      f"path's own inputs"
                      f"{' (equal to the parent design)' if parent else ''}"
                      f" and at Lq={LONG_LQ}, S=256 (three "
                      f"launches), and at dim 256 / 768 (Ld 129) and Ld "
                      f"12,000 / 20,000 (dim 128), b=2 and 4; timed at "
                      f"b={bits}; bound: valid tokens' "
                      f"bytes, products at 3 passes of the TF32 rate "
                      f"{_hw().PEAK_FLOPS_TF32:.4g}/s, reconstruction at f32")


def _long_queries(torch, dev, Nq, dim, seed):
    """Unit query vectors of LONG_LQ tokens, about a tenth masked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((Nq, LONG_LQ, dim), generator=g, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    return q, torch.rand((Nq, LONG_LQ), generator=g, device=dev) > 0.1


def persist_path(rt, torch, model, queries, stats, S, I):
    """Serve the main build's artifact with ``Searcher.from_dir``: the
    same codes, kernels and card, so the results must be equal."""
    from repro_torch.core.persist import artifact_bytes

    def drive():
        t0 = time.perf_counter()
        searcher = rt.Searcher.from_dir(model, ARTIFACT_DIR,
                                        encode_batch=QUERY_BATCH)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        return searcher, load_s, _search_all(searcher, queries)

    loaded, load_s, (S1, I1) = run_path("from_dir", torch, drive)
    nbytes = artifact_bytes(ARTIFACT_DIR)
    print(f"artifact: {nbytes} bytes on disk (index_bytes "
          f"{stats.index_bytes}), device bytes after load "
          f"{loaded.index.device_bytes()} (build's {stats.device_bytes}); "
          f"load {load_s:.4f}s; save {stats.stage_seconds['save']:.4f}s")
    if nbytes != stats.index_bytes:
        raise AssertionError("artifact bytes differ from index_bytes")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("from_dir results differ from the in-memory "
                             "index's")
    print("from_dir: results equal the in-memory index's exactly")


def host_probe_path(torch, index, searcher, queries, S, I):
    """The same index through the host probe path (prune engaged at
    ndocs = 1024); then device and host steady search times."""
    index.probe_kernel = "host"
    S1, I1 = run_path("host_probe", torch,
                      lambda: _search_all(searcher, queries))
    _agree("host probe path vs device path", S, I, S1, I1)
    qv = searcher.encode_queries(queries)
    host_s = _steady_search_s(torch, searcher, qv)
    index.probe_kernel = "auto"
    dev_s = _steady_search_s(torch, searcher, qv)
    print(f"index search, {N_QUERIES} queries steady: device path "
          f"{dev_s:.4f}s, host path {host_s:.4f}s")


def dense_path(rt, torch, model, docs, queries):
    """A 512-doc plaid index where every doc is a candidate (nprobe = K):
    the device plan is refused, the slate reaches n_docs, and the rerank
    is the all-pairs ``maxsim`` scan with a membership mask."""
    from repro_torch.core.plaid import device_probe_plan

    def drive():
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(nprobe=256),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=128)
        index, _ = indexer.build(docs[:DENSE_DOCS])
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        return index, searcher, _search_all(searcher, queries)

    index, searcher, (S, I) = run_path("dense", torch, drive)
    if device_probe_plan(index._plaid, QUERY_LEN, index.nprobe,
                         index.ndocs)[0]:
        raise AssertionError("dense: the device plan was not refused")
    cand, _ = index.candidates(searcher.encode_queries(queries[:QUERY_BATCH]))
    print(f"dense: {index.n_docs} docs, ndocs {index.ndocs}, slate width "
          f"{cand.shape[1]}")
    if cand.shape[1] < index.n_docs:
        raise AssertionError("dense: the slate did not reach n_docs")
    _check_results(S, I, index.n_docs)
    _agree("dense path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))


def flat_path(rt, torch, model, docs, queries):
    """A 4,096-doc flat index (Ward f=2): all-pairs ``maxsim``."""

    def drive():
        t0 = time.perf_counter()
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(backend="flat"),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=128)
        index, stats = indexer.build(docs[:FLAT_DOCS])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        return index, stats, build_s, searcher, _search_all(searcher,
                                                            queries)

    index, stats, build_s, searcher, (S, I) = run_path("flat", torch, drive)
    _check_results(S, I, index.n_docs)
    search_s = _steady_search_s(torch, searcher,
                                searcher.encode_queries(queries))
    print(f"flat: {stats.n_docs} docs, {stats.n_vectors_stored} vectors, "
          f"build {build_s:.3f}s, index bytes {stats.index_bytes}, device "
          f"bytes {stats.device_bytes}; index search {N_QUERIES} queries "
          f"steady {search_s:.4f}s")
    _agree("flat path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    return capture_maxsim_args(torch, searcher, queries), index


def recon_path(torch, index, searcher, queries, S, I):
    """The main index reranked from the f32 reconstruction store; returns
    the ``maxsim_rerank_indexed`` arguments of its first batch (the
    path's own slate, read from the store in place)."""
    index.packed_rerank = False
    S1, I1 = run_path("recon_rerank", torch,
                      lambda: _search_all(searcher, queries))
    recon_s = _steady_search_s(torch, searcher,
                               searcher.encode_queries(queries))
    args = capture_rerank_args(torch, searcher, queries)
    index.packed_rerank = True
    print(f"recon rerank: store {index._plaid.recon.device_nbytes()} device "
          f"bytes; index search {N_QUERIES} queries steady {recon_s:.4f}s")
    _agree("recon rerank vs packed rerank", S, I, S1, I1)
    return args


def capture_rerank_args(torch, searcher, queries):
    """The arguments of the ``maxsim_rerank_indexed`` call of one search
    batch. Outside every counted run."""
    from repro_torch.kernels.maxsim import ops as mo
    seen = []
    inner = mo.maxsim_rerank_indexed

    def keep(*args, **kw):
        if not seen:
            seen.append(args)
        return inner(*args, **kw)

    mo.maxsim_rerank_indexed = keep
    try:
        searcher.search(queries[:QUERY_BATCH], k=TOP_K)
    finally:
        mo.maxsim_rerank_indexed = inner
    if not seen:
        raise AssertionError("the search batch made no maxsim_rerank call")
    return seen[0]


def mutate_path(rt, torch, model, queries):
    """The main artifact loaded a second time with ``Searcher.from_dir``
    (the main index stays as it is), 512 of its docs deleted and 1,024 new
    docs added (encoded and Ward-pooled by the model, from a corpus of
    another seed), then 64 queries. Fails where a deleted id comes back,
    where the host probe path or the plain versions disagree, where an
    added doc's own vectors do not find it at top-1, or where the index
    saved and served again gives other results."""
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    cfg = model.cfg
    extra = SyntheticRetrievalCorpus(DatasetSpec(
        "chip-smoke-add", n_docs=MUTATE_ADD, n_queries=1, n_topics=64,
        doc_len_mean=200, doc_len_std=40, seed=SEED + 7),
        vocab_size=cfg.trunk.vocab_size).doc_token_batch(cfg.doc_maxlen - 2)

    def drive():
        searcher = rt.Searcher.from_dir(model, ARTIFACT_DIR,
                                        encode_batch=QUERY_BATCH)
        index = searcher.index
        n0 = index.n_docs
        dead = np.random.default_rng(SEED + 7).choice(n0, MUTATE_DELETE,
                                                      replace=False)
        t0 = time.perf_counter()
        index.delete(dead)
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(ndocs=NDOCS),
                             pooling_spec=rt.PoolingSpec("ward", 2),
                             encode_batch=ENCODE_BATCH)
        added = indexer.encode_and_pool(extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ids = index.add(added)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        # the add dropped the packed view: the figure before the search
        after_add = (index._plaid._packed_padded is None,
                     index._plaid.device_bytes_detail(), index.device_bytes())
        res = _search_all(searcher, queries)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        picks = np.linspace(0, MUTATE_ADD - 1, MUTATE_SELF).astype(int)
        own = [index.search(added[i], k=TOP_K)[1] for i in picks]
        return (searcher, index, dead, ids, picks, own, res, after_add,
                dict(delete_encode_s=t1 - t0, add_s=t2 - t1,
                     search_s=t3 - t2))

    (searcher, index, dead, ids, picks, own, (S, I), after_add,
     times) = run_path("mutate", torch, drive)
    dropped, detail, total = after_add
    built = sum(t.numel() * t.element_size()
                for t in index._plaid.padded_packed())
    print(f"mutate: after the add, before the next search (packed view "
          f"dropped: {dropped}): device_bytes {total}, detail "
          f"{json.dumps(detail)}; the search then built {built} packed bytes")
    if not (dropped and detail["packed"] == built
            and total == sum(detail.values())):
        raise AssertionError("mutate: device_bytes() after the add does not "
                             "count the packed view the search builds")
    SURFACE.update(mutate_after_add=dict(detail, device_bytes=total))
    print(f"mutate: {index.n_docs} docs ({MUTATE_DELETE} deleted, "
          f"{len(ids)} added as ids {ids[0]}..{ids[-1]}); device plan "
          f"{index._probe_plan(QUERY_LEN)[0]}; " + ", ".join(
              f"{k} {v:.4f}" for k, v in times.items()))
    _check_results(S, I, index.n_docs)
    if np.isin(I, dead).any():
        raise AssertionError("mutate: a deleted doc came back")
    top1 = [int(o[0]) if len(o) else -1 for o in own]
    hits = int(sum(t == ids[i] for t, i in zip(top1, picks)))
    print(f"mutate: added docs found at top-1 by their own vectors: "
          f"{hits} of {len(picks)}")
    if hits != len(picks):
        raise AssertionError(f"mutate: added docs not at top-1 of their own "
                             f"vectors: {list(zip(ids[picks], top1))}")
    index.probe_kernel = "host"
    _agree("mutate host probe path vs device path", S, I,
           *_search_all(searcher, queries))
    index.probe_kernel = "auto"
    _agree("mutate vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    shutil.rmtree(MUTATE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    index.save(MUTATE_DIR)
    save_s = time.perf_counter() - t0
    loaded = rt.Searcher.from_dir(model, MUTATE_DIR, encode_batch=QUERY_BATCH)
    S1, I1 = _search_all(loaded, queries)
    shutil.rmtree(MUTATE_DIR, ignore_errors=True)
    print(f"mutate: saved compacted in {save_s:.4f}s, {loaded.index.n_docs} "
          f"docs, {len(loaded.index.deleted)} dead")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("mutate: the reloaded index's results differ")
    print("mutate: reloaded results equal the mutated index's exactly")


def _same_arrays(a, b) -> bool:
    """Two lists of numpy arrays, bit for bit (dtype, shape, bytes)."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def surface_path(rt, torch, model, docs, queries, index, searcher):
    """The reference's names on the card (the docstring's ``surface``):
    the two compaction forms, the ``Indexer`` shorthand against the spec
    build, the main index's device bytes, and the forced kernels."""
    import warnings
    from repro_torch.core.pooling import (compact_pooled,
                                          compact_pooled_begin,
                                          compact_pooled_finish,
                                          compact_pooled_flat)
    from repro_torch.kernels.plaid_probe import plaid_probe_scores
    from repro_torch.kernels.ward_pool import ward_assign
    from repro_torch.models.colbert import encode_docs
    t0 = time.perf_counter()
    v, emit = encode_docs(model, docs[:ENCODE_BATCH])
    pooled, pmask = rt.PoolingSpec("ward", 2).apply(v, emit)
    lst = compact_pooled(pooled, pmask)
    flat, counts = compact_pooled_flat(pooled, pmask)
    for what, other in (
            ("compact_pooled_finish(compact_pooled_begin(...))",
             compact_pooled_finish(compact_pooled_begin(pooled, pmask))),
            ("compact_pooled_flat split by its counts",
             np.split(flat.cpu().numpy(),
                      np.cumsum(counts.cpu().numpy()[:-1])))):
        if not _same_arrays(lst, other):
            raise AssertionError(f"surface: compact_pooled differs from "
                                 f"{what}")
    print(f"surface: compact_pooled of the first pooled batch ({len(lst)} "
          f"docs, {sum(len(a) for a in lst)} rows) bitwise "
          f"finish(begin) and compact_pooled_flat")

    sub = docs[:COMPACT_BATCHES * ENCODE_BATCH]
    short_dir, spec_dir = SURFACE_DIR + "_short", SURFACE_DIR + "_spec"

    def drive():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            short = rt.Indexer(model, pool_method="ward", pool_factor=2,
                               backend="plaid", ndocs=SURFACE_NDOCS,
                               encode_batch=ENCODE_BATCH)
        built, _ = short.build(sub, out_dir=short_dir)
        res = _search_all(rt.Searcher(model, built,
                                      encode_batch=QUERY_BATCH), queries)
        return short, caught, built, res

    short, caught, built, (S, I) = run_path("surface", torch, drive)
    spec_ix = rt.Indexer(
        model, index_spec=rt.IndexSpec.from_config(
            model.cfg, backend="plaid", ndocs=SURFACE_NDOCS),
        pooling_spec=rt.PoolingSpec("ward", 2), encode_batch=ENCODE_BATCH)
    spec_index, _ = spec_ix.build(sub, out_dir=spec_dir)
    S1, I1 = _search_all(rt.Searcher(model, spec_index,
                                     encode_batch=QUERY_BATCH), queries)
    same_specs = (dataclasses.asdict(short.index_spec)
                  == dataclasses.asdict(spec_ix.index_spec)
                  and dataclasses.asdict(short.pooling)
                  == dataclasses.asdict(spec_ix.pooling))
    same_payloads = _artifact_digests(short_dir) == _artifact_digests(
        spec_dir)
    shutil.rmtree(short_dir, ignore_errors=True)
    shutil.rmtree(spec_dir, ignore_errors=True)
    valid = I >= 0
    print(f"surface: Indexer shorthand over {len(sub)} docs: specs equal "
          f"{same_specs}, payloads byte-equal {same_payloads}, deprecation "
          f"warned {any(w.category is DeprecationWarning for w in caught)}; "
          f"{N_QUERIES} queries ids equal {np.array_equal(I, I1)}, scores "
          f"equal {np.array_equal(S, S1)} ({int(valid.sum())} of {I.size} "
          f"slots filled at ndocs {SURFACE_NDOCS})")
    if not (same_specs and same_payloads and np.array_equal(I, I1)
            and np.array_equal(S, S1)):
        raise AssertionError("surface: the shorthand Indexer differs from "
                             "the spec-built one")
    if not any(w.category is DeprecationWarning for w in caught):
        raise AssertionError("surface: Indexer(**index_kw) did not warn")
    if not (np.isfinite(S[valid]).all() and (I[valid] < built.n_docs).all()
            and valid[:, 0].all()):
        raise AssertionError("surface: invalid shorthand search results")
    del built, spec_index

    p = index._plaid
    detail = p.device_bytes_detail()
    resident = sum(t.numel() * t.element_size() for t in p.padded_packed())
    print(f"surface: main index device_bytes_detail {json.dumps(detail)} "
          f"(device_bytes {index.device_bytes()}); packed {detail['packed']} "
          f"against {resident} bytes of the resident padded_packed() "
          f"tensors")
    if detail["packed"] != resident or index.device_bytes() != sum(
            detail.values()):
        raise AssertionError("surface: device_bytes_detail's packed is not "
                             "the resident packed view")

    ward_kernel = ward_assign(v, emit, 2, impl="kernel")
    ward_auto = ward_assign(v, emit, 2)
    args = capture_path_args(torch, searcher, queries)[0]
    probe_kernel = plaid_probe_scores(*args, t_cs=index.t_cs, impl="kernel")
    probe_auto = plaid_probe_scores(*args, t_cs=index.t_cs)
    torch.cuda.synchronize()
    forced = dict(ward_pool=torch.equal(ward_kernel, ward_auto),
                  plaid_probe=torch.equal(probe_kernel, probe_auto))
    print(f"surface: impl='kernel' bitwise 'auto': {forced}")
    if not all(forced.values()):
        raise AssertionError(f"surface: impl='kernel' differs from 'auto': "
                             f"{forced}")
    seconds = time.perf_counter() - t0
    print(f"surface: {seconds:.1f} s")
    SURFACE.update(main_device_bytes_detail=detail, seconds=seconds,
                   launches=PATH_LAUNCHES["surface"],
                   shorthand_slots_filled=int(valid.sum()))


def hnsw_path(rt, torch, model, docs, queries):
    """An hnsw index through ``Indexer.build`` (Ward f=4, 128 docs, the
    graph built in host Python), 16 docs added and 8 deleted, 32 queries:
    the token probes on the host, the rerank by ``maxsim_rerank`` reading
    the slate from the store in place. Held to the plain versions and to
    the flat backend's exact MaxSim over the same slate; saved and served
    again by ``Searcher.from_dir`` with equal results."""
    from repro_torch.core.maxsim import topk_with_pads
    nq = QUERY_BATCH

    def drive():
        t0 = time.perf_counter()
        indexer = rt.Indexer(
            model, index_spec=rt.IndexSpec(backend="hnsw",
                                           hnsw_candidates=HNSW_CANDIDATES),
            pooling_spec=rt.PoolingSpec("ward", HNSW_FACTOR),
            encode_batch=ENCODE_BATCH)
        index, stats = indexer.build(docs[:HNSW_DOCS])
        build_s = time.perf_counter() - t0
        more = indexer.encode_and_pool(docs[HNSW_DOCS:HNSW_DOCS + HNSW_ADD])
        t0 = time.perf_counter()
        index.add(more)
        add_s = time.perf_counter() - t0
        dead = np.random.default_rng(SEED + 8).choice(
            index.n_docs, HNSW_DELETE, replace=False)
        index.delete(dead)
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        t0 = time.perf_counter()
        res = searcher.search(queries[:nq], k=TOP_K)
        torch.cuda.synchronize()
        return (index, stats, build_s, add_s, dead, searcher, res,
                time.perf_counter() - t0)

    index, stats, build_s, add_s, dead, searcher, (S, I), search_s = \
        run_path("hnsw", torch, drive)
    qv = searcher.encode_queries(queries[:nq])
    cand, cmask = index.candidates(qv)
    counts = cmask.sum(1).float()
    cos = float(torch.einsum("qld,qmd->qlm", qv, qv).mean())
    print(f"hnsw: {index.n_docs} docs, {index._hnsw.vectors.shape[0]} token "
          f"vectors in the graph (M {index.hnsw_m}, ef_construction "
          f"{index.hnsw_ef_construction}); build {build_s:.3f}s (graph and "
          f"store: index stage {stats.stage_seconds['index']:.3f}s), add "
          f"{HNSW_ADD} docs {add_s:.3f}s; {nq} queries searched in "
          f"{search_s:.3f}s; slate width {cand.shape[1]}, valid per query "
          f"min {int(counts.min())} median {float(counts.median()):.0f} max "
          f"{int(counts.max())}; a query's tokens: mean pairwise cosine "
          f"{cos:.4f}")
    if cand.shape[1] >= index.n_docs:
        raise AssertionError("hnsw: the slate reached n_docs")
    found = I >= 0            # a slate of fewer than k docs pads with -1
    if not (np.isfinite(S[found]).all() and (I[found] < index.n_docs).all()
            and np.isneginf(S[~found]).all() and found[:, 0].all()):
        raise AssertionError("hnsw: invalid results")
    print(f"hnsw: results a query min {int(found.sum(1).min())} mean "
          f"{float(found.sum(1).mean()):.2f} of k = {TOP_K}")
    if np.isin(I, dead).any():
        raise AssertionError("hnsw: a deleted doc came back")
    _agree("hnsw vs plain versions", S, I,
           *searcher.search(queries[:nq], k=TOP_K, impl="ref"))
    flat = rt.MultiVectorIndex(dim=index.dim, backend="flat")
    flat.add(index.docs)
    flat.delete(dead)
    _agree("hnsw vs the flat backend's MaxSim over the hnsw slate", S, I,
           *topk_with_pads(flat.rerank(qv, cand, cmask), cand, TOP_K))
    shutil.rmtree(HNSW_DIR, ignore_errors=True)
    index.save(HNSW_DIR)
    loaded = rt.Searcher.from_dir(model, HNSW_DIR, encode_batch=QUERY_BATCH)
    S1, I1 = loaded.search(queries[:nq], k=TOP_K)
    shutil.rmtree(HNSW_DIR, ignore_errors=True)
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("hnsw: from_dir results differ")
    print("hnsw: from_dir results equal the in-memory index's exactly")


def plaid_k8192_path(rt, torch, model, flat_index, queries):
    """A plaid index at K = 8,192 over the flat path's stored pooled
    vectors (``add_flat``: nothing encoded again), nprobe 32, ndocs 16
    (``K8192_NPROBE``: the prune then cuts every query's slate). Its
    ``doc_member`` (8,192 x 4,096) is above the gather cap, so ``"auto"``
    takes the host path; ``probe_kernel="device"`` forces the device
    path. Both prune with ``plaid_probe`` at K = 8,192 (the global-table
    route) and must agree with each other and with the plain versions."""
    from repro_torch.core.plaid import (_centroid_scores_batch, _ladder,
                                        probe_members)
    store = flat_index._store

    def drive():
        t0 = time.perf_counter()
        index = rt.MultiVectorIndex(dim=flat_index.dim, n_centroids=K8192,
                                    nprobe=K8192_NPROBE, ndocs=K8192_NDOCS)
        index.add_flat(store.flat, store.doc_lengths())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        t0 = time.perf_counter()
        host = _search_all(searcher, queries)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        index.probe_kernel = "device"
        t0 = time.perf_counter()
        device = _search_all(searcher, queries)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - t0
        return index, searcher, build_s, host, host_s, device, device_s

    index, searcher, build_s, (S, I), host_s, (S1, I1), device_s = run_path(
        "plaid_k8192", torch, drive)
    index.probe_kernel = "auto"
    if index._probe_plan(QUERY_LEN)[0]:
        raise AssertionError("plaid_k8192: auto took the device path")
    index.probe_kernel = "device"
    if not index._probe_plan(QUERY_LEN)[0]:
        raise AssertionError("plaid_k8192: the device path was refused")
    qv = searcher.encode_queries(queries)
    counts = _candidate_report(torch, index, qv)
    p = index._plaid
    _, at8 = probe_members(_centroid_scores_batch(qv, p.codec.centroids),
                           torch.ones(qv.shape[:2], dtype=torch.bool,
                                      device=qv.device),
                           p.device_ivf().doc_member,
                           torch.ones(p.n_docs, dtype=torch.bool,
                                      device=qv.device), 8)
    print(f"plaid_k8192: at nprobe 8 (the default), candidates per query "
          f"min {int(at8.min())} max {int(at8.max())}")
    pruned = [_ladder(int(counts[lo:lo + QUERY_BATCH].max())) > index.ndocs
              for lo in range(0, len(counts), QUERY_BATCH)]
    cut = int((counts > index.ndocs).sum())
    print(f"plaid_k8192: {p.n_docs} docs, {p.n_vectors} vectors, K "
          f"{p.codec.n_centroids}; build {build_s:.3f}s; {N_QUERIES} queries "
          f"host path {host_s:.4f}s, device path {device_s:.4f}s (first "
          f"pass); "
          f"batches pruned {pruned}, queries cut to ndocs {cut} of "
          f"{len(counts)}")
    if not all(pruned):
        raise AssertionError("plaid_k8192: the prune did not engage")
    _check_results(S, I, p.n_docs)
    _agree("plaid_k8192 host path vs device path", S, I, S1, I1)
    _agree("plaid_k8192 device path vs plain versions", S1, I1,
           *_search_all(searcher, queries, impl="ref"))
    index.probe_kernel = "auto"
    _agree("plaid_k8192 host path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    return capture_probe_args(searcher, queries)


def capture_probe_args(searcher, queries):
    """The arguments of the ``plaid_probe`` call of one search batch.
    Outside every counted run."""
    import repro_torch.core.plaid as cp
    seen = []
    inner = cp.plaid_probe_scores

    def keep(*args, **kw):
        seen.append(args)
        return inner(*args, **kw)

    cp.plaid_probe_scores = keep
    try:
        searcher.search(queries[:QUERY_BATCH], k=TOP_K)
    finally:
        cp.plaid_probe_scores = inner
    if not seen:
        raise AssertionError("the search batch made no plaid_probe call")
    return seen[0]


def sharding_path(rt, torch, dev, card, model, flat_index, queries):
    """One rank on the card: the replicated flat index's plans over the
    flat path's 4,096-doc index (a one-cell plan; a forced plan over 4
    shards falls back to the dispatch merge). ``moe_ep`` follows later
    (``sharding_ep``): its profiled call would leave ``search_split``
    no device time."""
    from repro_torch.core.replicated import ReplicatedIndex, _FlatPlan
    from repro_torch.core.sharded import ShardedIndex
    fails = _checks()
    qv = rt.Searcher(model, flat_index,
                     encode_batch=QUERY_BATCH).encode_queries(queries)
    S0, I0 = flat_index.search_batch(qv, k=TOP_K)

    def drive():
        rep = ReplicatedIndex.replicate(flat_index, 2, use_shard_map=True)
        return rep, [rep.search_batch_on(r, qv, k=TOP_K) for r in range(2)]

    rep, lanes = run_path("sharding", torch, drive)
    plans = [rep._plans.get(r) for r in range(2)]
    _check(fails, all(isinstance(p, _FlatPlan) and len(p.cells) == 1
                      for p in plans),
           "sharding: each lane serves through a one-cell flat plan")
    _check(fails, all(np.array_equal(S, S0) and np.array_equal(I, I0)
                      for S, I in lanes),
           "sharding: the one-cell plan equals search_batch bitwise")

    def wall(fn, reps=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    plan_ms = wall(lambda: rep.search_batch(qv, k=TOP_K))
    flat_ms = wall(lambda: flat_index.search_batch(qv, k=TOP_K))
    store = flat_index._store
    cap = -(-int(store.n_vectors(live_only=False)) // SHARD_PARTS) + 256
    sharded = ShardedIndex(dim=flat_index.dim, backend="flat",
                           shard_max_vectors=cap,
                           doc_maxlen=flat_index.doc_maxlen,
                           device=flat_index.device)
    sharded.add(flat_index.docs)
    rep4 = ReplicatedIndex.replicate(sharded, 1, use_shard_map=True)
    S4, I4 = rep4.search_batch(qv, k=TOP_K)
    W4 = sharded.search_batch(qv, k=TOP_K)
    _check(fails, rep4._plan_for(0) is None,
           f"sharding: a forced plan over {sharded.n_shards} shards on one "
           f"card is refused (its row reuses the card)")
    _check(fails, np.array_equal(S4, W4[0]) and np.array_equal(I4, W4[1]),
           "sharding: the refused plan's dispatch merge equals the sharded "
           "index's search_batch bitwise")
    _agree("sharding: 4 flat shards vs the monolithic flat index", S4, I4,
           S0, I0)
    print(f"sharding: one-cell plan over {flat_index.n_docs} docs, "
          f"{QUERY_BATCH * 2} queries: {plan_ms:.3f} ms a search (host "
          f"clock, to the host result), the index's own search_batch "
          f"{flat_ms:.3f} ms; forced plan over {sharded.n_shards} shards: "
          f"dispatch merge [{card}]")
    del rep, rep4, sharded
    gc.collect()
    torch.cuda.empty_cache()
    _raise_failed("sharding", fails)
    return dict(plan_ms=plan_ms, flat_ms=flat_ms)


def sharding_ep(rt, torch, dev, card):
    """``moe_ep`` under a one-rank ("data", "model") mesh over NCCL, at
    one Moonshot MoE layer's width: the expert-parallel path against the
    dense oracle, timed (and one call profiled) beside ``moe_capacity``;
    without a context it is ``moe_capacity`` bit for bit."""
    import repro_torch.models.moe as moe
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.sharding.api import lm_rules, mesh_context
    fails = _checks()
    mcfg = rt.get_config(MOE_ARCH)
    T, E, k = EP_TOKENS, mcfg.n_experts, mcfg.top_k
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    layer = moe.MoE(mcfg, dev).requires_grad_(False)
    layer.router.reset_parameters(g)
    layer.reset_parameters(g)
    x = torch.randn((1, T, mcfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    # C_loc = T and cap_send = T k: nothing can drop
    roomy = dataclasses.replace(mcfg, capacity_factor=E / k)
    with torch.no_grad():
        y_cap, aux_cap = moe.moe_capacity(layer, x, mcfg)
        y_free, aux_free = moe.moe_ep(layer, x, mcfg)
        _check(fails, torch.equal(y_free, y_cap) and torch.equal(
            aux_free, aux_cap), "sharding: moe_ep without a context is "
                               "moe_capacity, bitwise")
        with process_group(dev):
            mesh = make_mesh((1, 1), ("data", "model"), dev)
            with mesh_context(mesh, lm_rules("data")):
                st = {}
                y_ep, aux_ep = moe.moe_ep(layer, x, roomy, capacity=T * k,
                                          stats=st)
                d_st = {}
                y_def, _ = moe.moe_ep(layer, x, mcfg, stats=d_st)
                ep_ms = _time_ms(lambda: moe.moe_ep(layer, x, mcfg))
                prof = _profile_step(torch, "sharding: moe_ep",
                                     lambda: moe.moe_ep(layer, x, mcfg))
            cap_ms = _time_ms(lambda: moe.moe_capacity(layer, x, mcfg))
        y_dense = torch.cat([moe.moe_dense(layer, x[:, i:i + KIMI_CHUNK],
                                           mcfg)[0]
                             for i in range(0, T, KIMI_CHUNK)], dim=1)
    err, rel = _errors(y_ep, y_dense)
    kept = int(st["keep2"].sum())
    drop = 1.0 - float(d_st["keep2"].sum()) / (T * k)
    d_err, d_rel = _errors(y_def, y_cap)
    print(f"sharding: moe_ep under a one-rank (data, model) mesh over NCCL, "
          f"{E} experts top {k}, d {mcfg.d_model}, {T} tokens: at cap_send "
          f"{st['cap_send']}, C_loc {st['C_loc']} (nothing can drop; "
          f"{kept} of {T * k} assignments kept) against the dense oracle: "
          f"max abs {err:.4g}, relative {rel:.4g} (limit {MOE_LAYER_REL}); "
          f"at its own default capacities (cap_send {d_st['cap_send']}, "
          f"C_loc {d_st['C_loc']}) it drops {drop:.6f} and differs from "
          f"moe_capacity by max abs {d_err:.4g}, relative {d_rel:.4g}; "
          f"moe_ep {ep_ms:.4f} ms (two all-to-alls and the replicated "
          f"output's broadcast over one rank), moe_capacity {cap_ms:.4f} ms "
          f"[{card}]")
    _check(fails, kept == T * k and bool(st["keep"].all()),
           "sharding: moe_ep (roomy) kept every assignment")
    _check(fails, rel <= MOE_LAYER_REL,
           f"sharding: moe_ep = dense within {MOE_LAYER_REL} relative")
    del layer, x, y_cap, y_free, y_ep, y_def, y_dense
    gc.collect()
    torch.cuda.empty_cache()
    _raise_failed("sharding", fails)
    return dict(ep_ms=ep_ms, capacity_ms=cap_ms, ep_max_abs=err, ep_rel=rel,
                ep_default_drop=drop, ep_profile=prof)


def _n_valid(cfg, docs):
    """Emitted (stored before pooling) vectors per doc, from the tokens."""
    import torch
    from repro_torch.models.colbert import emit_mask_docs, prepare_doc_tokens
    toks, attn = prepare_doc_tokens(torch.from_numpy(np.asarray(docs)),
                                    cfg.doc_maxlen)
    return emit_mask_docs(toks, attn, cfg.mask_punctuation).sum(1).numpy()


def kmeans_path(rt, torch, model, docs, queries):
    """A 4,096-doc plaid index pooled by per-document k-means (f=2)."""
    n_batches = -(-KMEANS_DOCS // ENCODE_BATCH)

    def drive():
        t0 = time.perf_counter()
        indexer = rt.Indexer(model,
                             index_spec=rt.IndexSpec(ndocs=KMEANS_NDOCS),
                             pooling_spec=rt.PoolingSpec("kmeans", 2),
                             encode_batch=ENCODE_BATCH)
        index, stats = indexer.build(docs[:KMEANS_DOCS])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        res = _search_all(searcher, queries)
        # no counted kernel runs here: printed before the launch check
        _candidate_report(torch, index, searcher.encode_queries(queries))
        return index, stats, build_s, searcher, res

    index, stats, build_s, searcher, (S, I) = run_path("kmeans", torch,
                                                       drive)
    launches = PATH_LAUNCHES["kmeans"]["kmeans_assign"]
    print(f"kmeans: {stats.n_docs} docs, build {build_s:.3f}s; stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in stats.stage_seconds.items())
          + f"; vectors raw {stats.n_vectors_raw}, stored "
          f"{stats.n_vectors_stored} (reduction {stats.vector_reduction:.4f});"
          f" kmeans_assign launches {launches} = 11 x {n_batches} encode "
          f"batches: {launches == 11 * n_batches}")
    if launches != 11 * n_batches:
        raise AssertionError("kmeans: kmeans_assign launches are not 11 per "
                             "encode batch")
    stored = np.diff(index._plaid.doc_offsets)
    cap = _n_valid(model.cfg, docs[:KMEANS_DOCS]) // 2 + 1
    if (stored > cap).any():
        raise AssertionError(f"kmeans: {int((stored > cap).sum())} docs "
                             f"store more than n_valid // 2 + 1 vectors")
    _check_results(S, I, index.n_docs)
    search_s = _steady_search_s(torch, searcher,
                                searcher.encode_queries(queries))
    print(f"kmeans: index search {N_QUERIES} queries steady {search_s:.4f}s")
    _agree("kmeans path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))


def sequential_path(rt, torch, model, docs, queries):
    """A 1,024-doc flat index pooled by sequential runs (f=2)."""

    def drive():
        indexer = rt.Indexer(model, index_spec=rt.IndexSpec(backend="flat"),
                             pooling_spec=rt.PoolingSpec("sequential", 2),
                             encode_batch=ENCODE_BATCH)
        index, stats = indexer.build(docs[:SEQUENTIAL_DOCS])
        searcher = rt.Searcher(model, index, encode_batch=QUERY_BATCH)
        return index, stats, _search_all(searcher, queries)

    index, stats, (S, I) = run_path("sequential", torch, drive)
    want = -(-_n_valid(model.cfg, docs[:SEQUENTIAL_DOCS]) // 2)
    stored = index._store.doc_lengths()
    print(f"sequential: {stats.n_docs} docs, vectors raw "
          f"{stats.n_vectors_raw}, stored {stats.n_vectors_stored}")
    if not np.array_equal(stored, want):
        raise AssertionError(f"sequential: {int((stored != want).sum())} "
                             f"docs do not store ceil(n_valid / 2) vectors")
    _check_results(S, I, index.n_docs)


def cascade_path(rt, torch, model, docs, queries):
    """``build_cascade`` with the reference's defaults over 4,096 docs."""

    def drive():
        t0 = time.perf_counter()
        cascade = rt.build_cascade(model, docs[:CASCADE_DOCS],
                                   encode_batch=ENCODE_BATCH)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        searcher = rt.Searcher(model, cascade, encode_batch=QUERY_BATCH)
        return cascade, build_s, searcher, _search_all(searcher, queries)

    cascade, build_s, searcher, (S, I) = run_path("cascade", torch, drive)
    _check_results(S, I, cascade.n_docs)
    search_s = _steady_search_s(torch, searcher,
                                searcher.encode_queries(queries))
    print(f"cascade: {cascade.n_docs} docs, coarse (f={cascade.coarse_factor})"
          f" {cascade.stage1_vectors()} + fine (f={cascade.fine_factor}) "
          f"{cascade.n_vectors() - cascade.stage1_vectors()} vectors, "
          f"{cascade.candidates} candidates; build {build_s:.3f}s; device "
          f"bytes {cascade.device_bytes()}; index search {N_QUERIES} "
          f"queries steady {search_s:.4f}s")
    _agree("cascade vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    return cascade, S, I, capture_rerank_args(torch, searcher, queries)


def cascade_from_dir_path(rt, torch, model, queries, cascade, S, I):
    """The cascade saved, then served by ``Searcher.from_dir``: the same
    vectors, kernels and card, so the results must be equal."""
    from repro_torch.core.persist import artifact_bytes
    shutil.rmtree(CASCADE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    cascade.save(CASCADE_DIR)
    save_s = time.perf_counter() - t0

    def drive():
        t0 = time.perf_counter()
        searcher = rt.Searcher.from_dir(model, CASCADE_DIR,
                                        encode_batch=QUERY_BATCH)
        torch.cuda.synchronize()
        return searcher, time.perf_counter() - t0, _search_all(searcher,
                                                               queries)

    loaded, load_s, (S1, I1) = run_path("cascade_from_dir", torch, drive)
    if not isinstance(loaded.index, rt.CascadeIndex):
        raise AssertionError(f"from_dir served a {type(loaded.index)}")
    print(f"cascade artifact: {artifact_bytes(CASCADE_DIR)} bytes, save "
          f"{save_s:.4f}s, load {load_s:.4f}s")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("cascade from_dir results differ from the "
                             "in-memory cascade's")
    print("cascade_from_dir: results equal the in-memory cascade's exactly")
    shutil.rmtree(CASCADE_DIR, ignore_errors=True)


def facade_path(rt, torch, model, queries, S, I):
    """``Retriever.load`` of the main artifact: the spec read back from
    its manifest is the main path's, and its search gives the main
    path's results exactly (the same codes, kernels and card)."""
    want = rt.RetrieverSpec(pooling=rt.PoolingSpec("ward", 2),
                            index=rt.IndexSpec(ndocs=NDOCS))

    def drive():
        r = rt.Retriever.load(model, ARTIFACT_DIR, encode_batch=QUERY_BATCH)
        return r, _search_all(r, queries)

    r, (S1, I1) = run_path("facade", torch, drive)
    print(f"facade: spec {r.spec.to_dict()}; stats n_docs {r.stats.n_docs}")
    if r.spec != want:
        raise AssertionError(f"facade: spec {r.spec} is not the main "
                             f"path's {want}")
    if not (np.array_equal(I, I1) and np.array_equal(S, S1)):
        raise AssertionError("facade: Retriever.load results differ from "
                             "the main path's")
    print("facade: spec and results equal the main path's exactly")


def _shard_report(torch, sharded, qv):
    """Each shard's docs, vectors and per-query candidate counts."""
    for i, (base, shard) in enumerate(zip(sharded.doc_base, sharded.shards)):
        print(f"  shard {i}: ids {base}..{base + shard.n_docs - 1}, "
              f"{shard.n_docs} docs, {shard.n_vectors()} vectors; ", end="")
        _candidate_report(torch, shard, qv)


def stream_path(rt, torch, model, docs, queries, card):
    """The main corpus streamed through ``Retriever.build`` with a
    ``ShardSpec`` into shards of at most 524,288 pooled vectors, saved
    shard by shard (pipelined flush), then 64 queries. A shard holds
    ~5,000 docs, whose candidate sets stay under 1024 at random weights
    (as the kmeans path's 4,096 docs), so the main path's ndocs = 1024
    would never prune: the shards take PLAID's k = 10 setting, ndocs =
    256, where ``plaid_probe`` prunes. Held tie-aware against the plain
    versions, the host probe path and ``Retriever.load`` of the artifact
    (which must give back the spec); then index search timed with the
    probe pool at auto and at one thread, on both candidate paths."""
    spec = rt.RetrieverSpec(
        pooling=rt.PoolingSpec("ward", 2),
        index=rt.IndexSpec(ndocs=STREAM_NDOCS),
        shard=rt.ShardSpec(shard_max_vectors=STREAM_SHARD_MAX))
    shutil.rmtree(STREAM_DIR, ignore_errors=True)

    def drive():
        t0 = time.perf_counter()
        r = rt.Retriever.build(model, docs, spec, out_dir=STREAM_DIR,
                               encode_batch=ENCODE_BATCH)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        r.searcher.encode_batch = QUERY_BATCH
        return r, build_s, _search_all(r, queries)

    r, build_s, (S, I) = run_path("stream", torch, drive)
    st, sharded = r.stats, r.index
    print(f"stream ({card}): {st.n_docs} docs, {st.n_shards} shards, "
          f"{st.n_vectors_stored} vectors (raw {st.n_vectors_raw}); build "
          f"{build_s:.3f}s = {st.n_docs / build_s:.1f} docs/s (main build "
          f"{MAIN_NUMBERS['build_docs_s']:.1f} docs/s); stages "
          + ", ".join(f"{k} {v:.3f}s" for k, v in st.stage_seconds.items()))
    print(f"stream ({card}): peak_buffered_vectors "
          f"{st.peak_buffered_vectors} (bound {STREAM_SHARD_MAX} + "
          f"max_batch_vectors {st.max_batch_vectors}); flush_wait_s "
          f"{st.flush_wait_s:.4f}; flush_busy_s {st.flush_busy_s:.4f}; "
          f"pipelined {st.pipelined}; index bytes {st.index_bytes}; device "
          f"bytes {st.device_bytes}")
    qv = r.searcher.encode_queries(queries)
    _shard_report(torch, sharded, qv[:QUERY_BATCH])
    if st.n_shards < 2 or st.n_docs != len(docs):
        raise AssertionError(f"stream: {st.n_shards} shards, {st.n_docs} "
                             f"docs")
    if st.peak_buffered_vectors > STREAM_SHARD_MAX + st.max_batch_vectors:
        raise AssertionError("stream: the pooled buffer outgrew its bound")
    _check_results(S, I, st.n_docs)
    _agree("stream vs plain versions", S, I,
           *_search_all(r.searcher, queries, impl="ref"))
    sharded.set_probe_kernel("host")
    _agree("stream host probe path vs device path", S, I,
           *_search_all(r, queries))
    sharded.set_probe_kernel("auto")
    loaded = rt.Retriever.load(model, STREAM_DIR, encode_batch=QUERY_BATCH)
    if loaded.spec != spec:
        raise AssertionError(f"stream: Retriever.load read back "
                             f"{loaded.spec}, built with {spec}")
    S1, I1 = _search_all(loaded, queries)
    _agree("stream Retriever.load vs built", S, I, S1, I1)
    print(f"stream: Retriever.load gives back the spec; results equal "
          f"exactly: {bool(np.array_equal(I, I1) and np.array_equal(S, S1))}")
    loaded.index.close()
    # the pool on the device candidate path, and on the host path (numpy,
    # the stage the reference's pool overlaps)
    for kernel in ("auto", "host"):
        sharded.set_probe_kernel(kernel)
        for pt in (0, 1):
            sharded.set_probe_threads(pt)
            search_s = _steady_search_s(torch, r.searcher, qv)
            _, _, probe_s = sharded.search_batch_with_stats(
                qv[:QUERY_BATCH], k=TOP_K)
            print(f"stream ({card}): index search {N_QUERIES} queries "
                  f"steady {search_s:.4f}s, probe_kernel {kernel}, "
                  f"probe_threads {pt} ({sharded.probe_threads} workers; "
                  f"main path {MAIN_NUMBERS['index_search_s']:.4f}s); "
                  "per-shard probe s of one batch "
                  + ", ".join(f"{p:.4f}" for p in probe_s))
    sharded.close()
    shutil.rmtree(STREAM_DIR, ignore_errors=True)


def _payload_digests(root):
    """{shard dir/payload name: sha256 of its .npy bytes}."""
    import hashlib
    from repro_torch.core.persist import read_manifest
    out = {}
    for e in read_manifest(root)["shards"]:
        sub = os.path.join(root, e["dir"])
        for name, p in read_manifest(sub)["payloads"].items():
            with open(os.path.join(sub, p["file"]), "rb") as fh:
                out[f"{e['dir']}/{name}"] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def stream_parity_path(rt, torch, model, docs, queries, card):
    """The first 4,096 docs streamed into ~4 shards with the flush
    pipelined and serial: every shard payload's sha256, the doc ids and
    the shard bases must be equal. At exhaustive settings (nprobe = K =
    256, ndocs 4,096: every shard takes the dense fallback through
    ``maxsim``) the sharded search must equal a monolithic
    ``Indexer.build`` of the same docs with the first shard's codec:
    ids tie-aware within 1e-5."""
    spec = rt.IndexSpec(nprobe=256, ndocs=PARITY_DOCS)
    sub = docs[:PARITY_DOCS]
    shutil.rmtree(PARITY_DIR, ignore_errors=True)

    def indexer():
        return rt.Indexer(model, index_spec=spec,
                          pooling_spec=rt.PoolingSpec("ward", 2),
                          encode_batch=ENCODE_BATCH)

    def drive():
        built = {}
        for pipe in (True, False):
            out = os.path.join(PARITY_DIR, f"pipeline_{pipe}")
            built[pipe] = indexer().build_streaming(
                sub, shard_max_vectors=PARITY_SHARD_MAX, out_dir=out,
                pipeline=pipe) + (out,)
        sharded = built[True][0]
        mono, _ = indexer().build(sub, codec=sharded.codec())
        searcher = rt.Searcher(model, sharded, encode_batch=QUERY_BATCH)
        mono_searcher = rt.Searcher(model, mono, encode_batch=QUERY_BATCH)
        return (built, mono, _search_all(searcher, queries),
                _search_all(mono_searcher, queries))

    built, mono, (S, I), (S0, I0) = run_path("stream_parity", torch, drive)
    (a, sa, da), (b, sb, db) = built[True], built[False]
    ha, hb = _payload_digests(da), _payload_digests(db)
    print(f"stream_parity ({card}): {sa.n_shards} shards of "
          f"{[s.n_docs for s in a.shards]} docs; {len(ha)} payloads; "
          f"pipelined flush_wait_s {sa.flush_wait_s:.4f} busy "
          f"{sa.flush_busy_s:.4f}, serial busy {sb.flush_busy_s:.4f}")
    differ = sorted(k for k in set(ha) | set(hb) if ha.get(k) != hb.get(k))
    if differ:
        raise AssertionError(f"stream_parity: pipelined and serial payloads "
                             f"differ: {differ}")
    if a.doc_base != b.doc_base or [s.n_docs for s in a.shards] != \
            [s.n_docs for s in b.shards]:
        raise AssertionError("stream_parity: shard layouts differ")
    print("stream_parity: pipelined and serial shard payloads have equal "
          "sha256, equal doc ids and bases")
    qv = rt.Searcher(model, a).encode_queries(queries[:QUERY_BATCH])
    for s in a.shards:
        cand, _ = s.candidates(qv)
        if cand.shape[1] < s.n_docs:
            raise AssertionError("stream_parity: a shard's slate did not "
                                 "reach n_docs")
    from repro_torch.core.maxsim import tie_aware_mismatches
    bad = tie_aware_mismatches(I0, S0, I, S, PARITY_ATOL)
    diff = float(np.abs(S - S0).max())
    print(f"stream_parity ({card}): sharded vs monolithic (same codec, "
          f"exhaustive): ids equal {float((I == I0).mean()):.4f}, tie-aware "
          f"mismatches {bad}, max score diff {diff:.3g} (zero: "
          f"{diff == 0.0})")
    _check_results(S, I, mono.n_docs)
    if bad or not np.allclose(S, S0, rtol=0, atol=PARITY_ATOL):
        raise AssertionError("stream_parity: sharded and monolithic "
                             "results disagree")
    a.close()
    b.close()
    shutil.rmtree(PARITY_DIR, ignore_errors=True)


def _ref_metric(name, ranked, qrels):
    """``name`` ("ndcg@10", ...) by the numpy reference metrics
    (``retrieval/metrics.py``) on ranked id lists."""
    from repro_torch.retrieval import metrics as R
    base, k = name.split("@")
    fn = {"ndcg": R.ndcg_at_k, "recall": R.recall_at_k,
          "success": R.success_at_k, "mrr": R.mrr_at_k}[base]
    return fn(ranked, qrels, int(k))


def eval_path(rt, torch, dev, model, docs, queries, qrels, searcher):
    """The paper's comparison through ``QualitySweep`` at full width over
    ``synthetic_dataset("trec-covid")`` (1,200 docs, 64 queries): Ward,
    k-means and sequential pooling at factors 1, 2, 3, 4 and 6, flat and
    plaid at 2 bits, every cell through the ``Retriever`` facade; then
    ``Retriever.evaluate`` of the main artifact (16,384 docs, 64 queries
    with qrels, the prune engaged), held to the numpy reference metrics
    on the same rankings and to a re-run on the plain versions. The
    paper's envelope (``run_gate``) is printed as a reading: it is the
    claim for trained encoders, and these weights are random."""
    from repro_torch.eval import (EvalDataset, QualitySweep,
                                  compute_metrics, run_gate,
                                  synthetic_dataset)
    from repro_torch.eval.metrics import max_k
    cfg = model.cfg
    ds = synthetic_dataset(EVAL_DATASET, cfg.trunk.vocab_size,
                           cfg.doc_maxlen - 2, cfg.query_maxlen - 2)

    def sweep():
        t0 = time.perf_counter()
        rep = QualitySweep(model, ds, methods=EVAL_METHODS,
                           factors=EVAL_FACTORS, backends=("flat", "plaid"),
                           quant_bits=(2,), metrics=EVAL_METRICS,
                           k=TOP_K, encode_batch=ENCODE_BATCH,
                           device=dev).run()
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    rep, sweep_s = run_path("eval_sweep", torch, sweep)
    n_valid = _n_valid(cfg, ds.doc_tokens)
    for c in rep.cells:
        if c.factor == 1:
            if not (c.shared_baseline
                    and all(v == 100.0 for v in c.relative.values())):
                raise AssertionError(f"eval: factor-1 cell {c.backend} "
                                     f"{c.method} is not exactly 100.0")
            continue
        f = c.factor
        if c.method == "sequential":
            want = int((-(-n_valid // f)).sum())
            ok = c.n_vectors == want
        else:                   # ward, kmeans: n_valid // f + 1 a doc
            want = int(np.minimum(n_valid, n_valid // f + 1).sum())
            ok = c.n_vectors <= want
        if not ok:
            raise AssertionError(f"eval: {c.backend} {c.method} f={f} "
                                 f"stores {c.n_vectors} vectors (bound "
                                 f"{want})")
    print(f"eval sweep: {EVAL_DATASET} ({ds.n_docs} docs, {ds.n_queries} "
          f"queries), {len(rep.cells)} cells over {len(rep.baselines)} "
          f"baselines in {sweep_s:.3f}s; factor-1 cells exactly 100.0, "
          f"stored vectors within their bounds")
    for backend, qb in (("flat", None), ("plaid", 2)):
        for metric in ("ndcg@10", "recall@5"):
            print(rep.markdown_table(metric, backend, qb))
    print(rep.summary())
    gate = run_gate(rep)
    print("eval: the paper's envelope (a reading at random weights, not "
          "enforced): " + gate.summary().replace("\n", "; "))

    main_ds = EvalDataset("chip-smoke", docs, queries, qrels)
    retr = rt.Retriever(model, searcher.index, encode_batch=QUERY_BATCH)
    depth = max(TOP_K, max_k(EVAL_METRICS))

    def evaluate():
        t0 = time.perf_counter()
        out = retr.evaluate(main_ds, metrics=EVAL_METRICS, k=TOP_K)
        return out, time.perf_counter() - t0

    got, eval_s = run_path("eval_main", torch, evaluate)
    S, I = retr.search(queries, k=depth)
    ranked = [[int(d) for d in row if d >= 0] for row in I]
    ref = {n: _ref_metric(n, ranked, qrels) for n in EVAL_METRICS}
    S1, I1 = searcher.search(queries, k=depth, impl="ref")
    _agree("eval_main rankings vs plain versions", S, I, S1, I1)
    plain = compute_metrics(I1, qrels, EVAL_METRICS, device=dev)
    # a tie-aware swap of two ranks moves a metric by at most one query
    swapped = int((I != I1).any(1).sum())
    print(f"eval_main: Retriever.evaluate of the main artifact in "
          f"{eval_s:.3f}s: " + ", ".join(
              f"{n} {v:.6f} (numpy reference {ref[n]:.6f}, plain versions "
              f"{plain[n]:.6f})" for n, v in got.items())
          + f"; {swapped} queries' rankings differ from the plain run "
            f"by ties")
    for n, v in got.items():
        if abs(v - ref[n]) > 1e-6:
            raise AssertionError(f"eval_main: {n} {v} against the numpy "
                                 f"reference's {ref[n]}")
        if abs(v - plain[n]) > 1e-6 + swapped / len(queries):
            raise AssertionError(f"eval_main: {n} {v} against the plain "
                                 f"versions' {plain[n]}")
    return dict(sweep_s=sweep_s, evaluate_s=eval_s, main_metrics=got,
                relative={f"{c.backend} {c.method} f={c.factor}":
                          c.relative["ndcg@10"] for c in rep.cells})


def serve_path(rt, torch, model, index, searcher, queries):
    """``Retriever.serve`` over the main artifact, saved to SERVE_DIR
    and watched (the engine serves its own copy, generation 1), with
    ``max_batch`` 32: 4 submitter threads send requests of 1-8 of the
    main corpus's queries; after half of SERVE_REQUESTS the main index is
    saved there again (generation 2) and the threads go on until the
    swap has served SERVE_AFTER_SWAP more requests. Fails on any failed
    request, a request outside the parity contract against a direct
    ``searcher.search`` of its tokens (both generations hold the same
    index), a kernel library loaded after ``start()``, or a retired
    generation whose device memory is not freed. Then closed-loop QPS at
    batch sizes 1, 8 and 32 and open-loop p50 / p99 at a fixed-seed
    Poisson rate."""
    import threading
    from repro_torch.core.maxsim import tie_aware_mismatches
    from repro_torch.launch.engine import CompileCounter, run_open_loop
    from repro_torch.launch.serve import serve_microbatches
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    retr = rt.Retriever(model, index, rt.RetrieverSpec(
        pooling=rt.PoolingSpec("ward", 2), index=rt.IndexSpec(ndocs=NDOCS)),
        encode_batch=QUERY_BATCH)
    retr.save(SERVE_DIR)
    spec = rt.ServeSpec(max_batch=SERVE_MAX_BATCH, k=TOP_K,
                        poll_interval_s=0.05)
    # the searcher's query graph (its static buffers) outlives the
    # engine: made before the baseline, it is not the engine's memory
    retr.searcher.encode_queries(queries[:1])
    gc.collect()
    torch.cuda.synchronize()
    level0 = torch.cuda.memory_allocated()
    done, lock = [], threading.Lock()
    errors, swap = [], {}

    def drive():
        eng = retr.serve(spec, index_dir=SERVE_DIR)
        t0 = time.perf_counter()
        eng.start()
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        level1 = torch.cuda.memory_allocated()
        first = eng._handle
        with CompileCounter() as cc:
            def client(seed):
                rng = np.random.default_rng(seed)
                try:
                    while True:
                        with lock:
                            sent = len(done)
                            if "t" in swap and sent >= max(
                                    SERVE_REQUESTS,
                                    swap["sent"] + SERVE_AFTER_SWAP):
                                return
                        lo, n = int(rng.integers(0, len(queries))), \
                            int(rng.integers(1, 9))
                        rows = (lo + np.arange(n)) % len(queries)
                        S, I = eng.submit(queries[rows]).result(timeout=120)
                        with lock:
                            done.append((rows, S, I))
                except BaseException as e:            # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(SEED + i,))
                       for i in range(SERVE_THREADS)]
            t_run = time.perf_counter()
            for t in threads:
                t.start()
            deadline = time.monotonic() + 300
            while len(done) < SERVE_REQUESTS // 2 and not errors and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            retr.save(SERVE_DIR)                       # generation 2
            t_pub = time.perf_counter()
            while eng.generation < 2 and time.monotonic() < deadline:
                time.sleep(0.001)
            with lock:
                swap.update(t=time.perf_counter() - t_pub, sent=len(done))
            for t in threads:
                t.join(timeout=300)
            run_s = time.perf_counter() - t_run
        drained = first.wait_drained(timeout=60)
        gc.collect()
        torch.cuda.synchronize()
        # the engine's one served copy is the one-index level; after the
        # swap drained, the retired copy's memory must be gone
        level2 = torch.cuda.memory_allocated()
        snap = eng.stats.snapshot()
        eng.stop()
        return (eng, snap, cc.count, start_s, run_s, level1, level2,
                drained, first.index is None)

    (eng, snap, compiles, start_s, run_s, level1, level2, drained,
     freed) = run_path("serve", torch, drive)
    gc.collect()
    torch.cuda.synchronize()
    level3 = torch.cuda.memory_allocated()        # the engine stopped
    print(f"serve: {len(done)} requests ({sum(len(r) for r, _, _ in done)} "
          f"queries) from {SERVE_THREADS} threads in {run_s:.3f}s; "
          f"start (load, warm every bucket) {start_s:.3f}s; swap to "
          f"generation 2 {swap.get('t', float('nan')):.4f}s after the "
          f"publish, at request {swap.get('sent')}; batches "
          f"{snap['batches']}, mean batch {snap['mean_batch_size']:.2f}, "
          f"flushes {snap['flush_reasons']}, generations "
          f"{sorted(set(snap['generations_seen']))}, failed "
          f"{snap['failed']}; kernel libraries loaded after start "
          f"{compiles}; device memory before the engine {level0}, one "
          f"served copy {level1}, after the swap drained {level2}, after "
          f"stop {level3}")
    if errors or snap["failed"]:
        raise AssertionError(f"serve: failed requests: {snap['failed']} "
                             f"{errors[:3]}")
    if eng.generation != 2 or sorted(set(snap["generations_seen"])) != [1, 2]:
        raise AssertionError("serve: the swap was not observed")
    if compiles:
        raise AssertionError(f"serve: {compiles} kernel libraries loaded "
                             f"after start()")
    if not (drained and freed) or level3 != level0 or \
            abs(level2 - level1) > 0.05 * (level1 - level0):
        raise AssertionError("serve: the retired generation's device "
                             "memory was not freed")
    bitwise = worst = 0
    for rows, S, I in done:
        S1, I1 = searcher.search(queries[rows], k=TOP_K)
        if tie_aware_mismatches(I1, S1, I, S, SCORE_ATOL) or \
                not np.allclose(S, S1, rtol=0, atol=SCORE_ATOL):
            raise AssertionError(f"serve: request {rows.tolist()} outside "
                                 f"the parity contract")
        bitwise += bool(np.array_equal(S, S1) and np.array_equal(I, I1))
        worst = max(worst, float(np.abs(S - S1).max()))
    print(f"serve parity: {len(done)} requests against direct "
          f"searcher.search, ids tie-aware, max score diff {worst:.3g}; "
          f"{bitwise} bitwise equal")

    # one query's encode at the searcher's one width (QUERY_BATCH rows,
    # what parity needs) and alone (one row, the reference's width)
    from repro_torch.models.colbert import encode_queries

    def host_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    enc_ms = {"width 32": host_ms(lambda: searcher.encode_queries(
        queries[:1])), "width 1": host_ms(lambda: encode_queries(
            model, queries[:1]))}
    print("serve: one query's encode, host ms with the card synced: "
          + ", ".join(f"{k} {v:.3f}" for k, v in enc_ms.items()))
    # what the one width buys: each query encoded alone (one row, the
    # reference's width for a lone query) against the searcher's width
    alone = torch.cat([encode_queries(model, queries[i:i + 1])[0]
                       for i in range(len(queries))])
    fixed = searcher.encode_queries(queries)
    Sa, Ia = searcher.search_encoded(alone, k=TOP_K)
    Sf, If = searcher.search_encoded(fixed, k=TOP_K)
    width = dict(vector_max_diff=float((alone - fixed).abs().max()),
                 queries_moved=int((Ia != If).any(1).sum()),
                 score_max_diff=float(np.abs(Sa - Sf).max()))
    print(f"serve: each query encoded alone against the searcher's width "
          f"({QUERY_BATCH} rows): vectors differ by up to "
          f"{width['vector_max_diff']:.3g}, top-{TOP_K} ids differ for "
          f"{width['queries_moved']} of {len(queries)} queries, scores by "
          f"up to {width['score_max_diff']:.3g}")
    closed = {}
    for bs in (1, 8, 32):
        lat, sizes = serve_microbatches(searcher, queries, bs,
                                        SERVE_CLOSED_QUERIES, k=TOP_K)
        closed[bs] = dict(qps=float(sizes.sum() / lat.sum()),
                          p50_ms=float(np.percentile(lat * 1e3, 50)),
                          p99_ms=float(np.percentile(lat * 1e3, 99)))
    with rt.Retriever(model, index, encode_batch=QUERY_BATCH).serve(
            spec.replace(poll_interval_s=0.2)) as eng:
        row = run_open_loop(eng, queries, SERVE_RATE, SERVE_OPEN_QUERIES,
                            k=TOP_K, seed=SEED)
        osnap = eng.stats.snapshot()
    print("serve closed loop (QPS, p50 / p99 ms a batch): " + ", ".join(
        f"batch {bs} {v['qps']:.1f} QPS, {v['p50_ms']:.3f} / "
        f"{v['p99_ms']:.3f}" for bs, v in closed.items())
          + f"; open loop at {SERVE_RATE:.0f} QPS offered (seed {SEED}, "
            f"{SERVE_OPEN_QUERIES} queries): achieved "
            f"{row['achieved_qps']:.1f}, p50 {row['latency_p50_ms']:.3f} ms,"
            f" p99 {row['latency_p99_ms']:.3f} ms, mean batch "
            f"{osnap['mean_batch_size']:.2f}, errors {row['errors']}")
    if row["errors"]:
        raise AssertionError(f"serve open loop: {row['errors']} errors")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return dict(requests=len(done), swap_s=swap.get("t"), bitwise=bitwise,
                encode_ms=enc_ms, width=width, closed=closed,
                open_p50_ms=row["latency_p50_ms"],
                open_p99_ms=row["latency_p99_ms"])


def _packed_shapes(torch, dev, run, errs):
    """``maxsim_packed`` at the shapes its token windows and dim slabs
    opened (dim 256 and 768 at Ld 129, Ld 12,000 and 20,000 at dim 128,
    b = 2 and 4), random codes, about half of each document valid; held
    to the plain version and timed beside it, with the bound."""
    out = {}
    for dim, Ld in PACKED_SHAPES:
        for bits in (2, 4):
            g = torch.Generator(device=dev).manual_seed(dim + Ld + bits)
            Nq, S = PACKED_SHAPE_NQ, PACKED_SHAPE_S
            q = torch.randn((Nq, QUERY_LEN, dim), generator=g, device=dev)
            q = q / q.norm(dim=-1, keepdim=True)
            cen = torch.randn((256, dim), generator=g, device=dev)
            cen = cen / cen.norm(dim=-1, keepdim=True)
            args = (q, torch.ones((Nq, QUERY_LEN), dtype=torch.bool,
                                  device=dev),
                    torch.randint(-2 ** 31, 2 ** 31 - 1,
                                  (Nq, S, Ld, dim * bits // 32), generator=g,
                                  device=dev, dtype=torch.int32),
                    torch.randint(0, 256, (Nq, S, Ld), generator=g,
                                  device=dev, dtype=torch.int32),
                    torch.rand((Nq, S, Ld), generator=g, device=dev) < 0.5,
                    cen, torch.randn((dim, 1 << bits), generator=g,
                                     device=dev) * 0.05)
            what = f"dim={dim},Ld={Ld},b={bits}"
            err = _hold(f"maxsim_packed {what}", torch, run(args, bits),
                        run(args, bits, "ref"), errs)
            bound, by = _packed_bound(*args)
            out[what] = dict(ms=_time_ms(lambda: run(args, bits)),
                             plain_ms=_time_ms(lambda: run(args, bits, "ref"),
                                               reps=1),
                             bound_ms=bound, bound_by=by, max_abs_err=err)
            del args
            torch.cuda.empty_cache()
    print(f"maxsim_packed at the new shapes (Nq={PACKED_SHAPE_NQ}, "
          f"S={PACKED_SHAPE_S}, Lq={QUERY_LEN}, half valid; ms, plain ms, "
          f"bound ms): " + "; ".join(
              f"{k} {v['ms']:.4f}, {v['plain_ms']:.4f}, {v['bound_ms']:.4f} "
              f"({v['bound_by']}), err {v['max_abs_err']:.3g}"
              for k, v in out.items()))
    return out


def capture_path_args(torch, searcher, queries):
    """The arguments of the ``plaid_probe`` and ``maxsim_packed`` calls of
    the first main-path batch whose prune engages (both kernels run), and
    that batch's encoded queries. Outside every counted run."""
    import repro_torch.core.plaid as cp
    seen = {}

    def keep(name, fn):
        def wrapped(*args, **kw):
            seen.setdefault(name, args)
            return fn(*args, **kw)
        return wrapped

    probe, packed = cp.plaid_probe_scores, cp.maxsim_packed_rerank
    cp.plaid_probe_scores = keep("plaid_probe", probe)
    cp.maxsim_packed_rerank = keep("maxsim_packed", packed)
    try:
        for lo in range(0, len(queries), QUERY_BATCH):
            seen.clear()
            qv = searcher.encode_queries(queries[lo:lo + QUERY_BATCH])
            searcher.search_encoded(qv, k=TOP_K)
            if len(seen) == 2:
                return seen["plaid_probe"], seen["maxsim_packed"], qv
    finally:
        cp.plaid_probe_scores, cp.maxsim_packed_rerank = probe, packed
    raise AssertionError("no main-path batch ran both plaid_probe and "
                         "maxsim_packed")


# The ``search.*`` ranges of one batch: the main path's (packed rerank)
# and the recon_rerank path's (the f32 rerank from the store)
CANDIDATE_STAGES = ("search.centroid_scores", "search.probe_members",
                    "search.code_gather", "search.plaid_probe",
                    "search.prune")
SPLIT_STAGES = CANDIDATE_STAGES + ("search.packed_gather",
                                   "search.maxsim_packed", "search.topk")
RECON_STAGES = CANDIDATE_STAGES + ("search.maxsim_rerank", "search.topk")


# Kernels each of these stages must show in the trace.
STAGE_KERNELS = {"search.plaid_probe": ("plaid_table_kernel",
                                        "plaid_probe_kernel"),
                 "search.maxsim_packed": ("maxsim_packed_kernel",),
                 "search.maxsim_rerank": ("maxsim_tc_kernel",)}


def search_split(torch, searcher, qv, stages=SPLIT_STAGES, label="main"):
    """Device time of each stage (``stages``) of one ``search_encoded``
    batch, from a ``torch.profiler`` trace of that call. Each device activity
    (kernel or copy) is matched to the runtime call that launched it (the
    two share an id) and given to the innermost ``search.*`` range around
    that call (``core/plaid.py``, ``core/index.py``): ctypes launches
    count as aten's do. The batch's time on the device's clock (CUDA
    events around the call) against all its device work gives the
    device's idle share. Raises where a stage shows no device time (the
    prune must engage) or misses its kernels. -> {stage: ms, "batch": ms,
    "device busy": ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    searcher.search_encoded(qv, k=TOP_K)            # warm
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        searcher.search_encoded(qv, k=TOP_K)
        end.record()
        torch.cuda.synchronize()
    events = prof.events()
    calls = {e.id: e for e in events                # runtime calls: cuda*
             if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    split = dict.fromkeys(stages, 0.0)
    names = {k: set() for k in stages}
    busy = 0.0
    for w in events:
        if w.device_type != DeviceType.CUDA or w.is_user_annotation:
            continue
        ms = w.time_range.elapsed_us() / 1e3
        busy += ms
        p = calls.get(w.id)
        while p is not None and p.name not in split:
            p = p.cpu_parent
        if p is not None:
            split[p.name] += ms
            names[p.name].add(w.name)
    for name in stages:
        missing = [k for k in STAGE_KERNELS.get(name, ())
                   if not any(k in n for n in names[name])]
        if split[name] <= 0 or missing:
            raise AssertionError(f"split: {name} shows {split[name]} ms of "
                                 f"device time, kernels missing {missing}")
    staged = sum(split.values())
    split["batch"] = start.elapsed_time(end)
    split["device busy"] = busy
    print(f"{label} index search split of one {qv.shape[0]}-query batch "
          f"(torch.profiler device time, ms; the batch "
          f"{split['batch']:.4f} ms on CUDA events, the device busy "
          f"{busy:.4f} ms, idle share {1 - busy / split['batch']:.3f}, "
          f"outside the stages {busy - staged:.4f}): " + ", ".join(
              f"{k[len('search.'):]} {split[k]:.4f}" for k in stages))
    return split


# Runtime calls that launch device work (a graph's kernels launch as one)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
QG_BATCH = 256                     # the search-batch cell's encode width
QG_REPS = 20                       # batches a host timing
QG_ATOL = 0.01                     # a GEMM picked anew moves bf16 by ~3e-3


def _launches_of(torch, fn):
    """(runtime launch calls, kernels) of one profiled ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS:
            calls += 1
        elif (e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and not e.name.startswith(("Memcpy", "Memset"))):
            kernels += 1
    return calls, kernels


def query_graph_row(rt, torch, dev):
    """JaColBERTv2's query encode at the search cell's width ([256, 32]):
    eager (``models.colbert.encode_queries`` of one chunk, the searcher's
    path off the card) against ``Searcher.encode_queries``' CUDA graph.
    Each: the largest difference from eager, host ms a batch (raw ids in,
    vectors on the card, synced; ``QG_REPS`` batches), device ms a batch
    (CUDA events behind a sleep kernel, ids already on the card: the
    eager forward, or the graph's replay; one batch, so the eager host's
    queueing stays inside the sleep) and launches a batch (runtime
    launch calls and kernels, one profiled batch). Fails where the graph
    differs by more than ``QG_ATOL`` or launches as often as eager."""
    from repro_torch.configs import get_ja_config
    from repro_torch.models.colbert import encode_queries, init_colbert
    cfg = get_ja_config()
    model = init_colbert(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    L = cfg.query_maxlen - 2
    q = rng.integers(8, cfg.trunk.vocab_size, (QG_BATCH, L))
    q[:, L // 2:] *= rng.random((QG_BATCH, L - L // 2)) < 0.5   # pads
    searcher = rt.Searcher(model, None, encode_batch=QG_BATCH)
    want = encode_queries(model, q)[0]
    got = searcher.encode_queries(q)              # captured here
    graph = searcher._graphs[QG_BATCH]
    ids = torch.as_tensor(graph.stage(q).copy(), device=dev)
    graph.ids.copy_(ids)
    paths = {"eager": (lambda: encode_queries(model, q)[0],
                       lambda: graph.encode_ids(ids)),
             "graph": (lambda: searcher.encode_queries(q),
                       graph.graph.replay)}
    row = {"shape": [QG_BATCH, cfg.query_maxlen],
           "max_abs_diff": (got - want).abs().max().item()}
    for name, (call, device_work) in paths.items():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(QG_REPS):
            call()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / QG_REPS
        with torch.no_grad():      # one batch: the eager host queues ~20 ms
            device_ms = _time_ms(device_work, reps=1)
        calls, kernels = _launches_of(torch, call)
        row[name] = {"host_ms": host_ms, "device_ms": device_ms,
                     "launch_calls": calls, "kernels": kernels}
    print(f"query graph at [{QG_BATCH}, {cfg.query_maxlen}] (jacolbertv2): "
          f"max abs diff {row['max_abs_diff']:.3g}; " + "; ".join(
              f"{k} host {row[k]['host_ms']:.3f} ms, device "
              f"{row[k]['device_ms']:.3f} ms, {row[k]['launch_calls']} "
              f"launch calls, {row[k]['kernels']} kernels" for k in paths))
    if not row["max_abs_diff"] <= QG_ATOL:
        raise AssertionError(f"query graph: max abs diff "
                             f"{row['max_abs_diff']} above {QG_ATOL}")
    if row["graph"]["launch_calls"] >= row["eager"]["launch_calls"]:
        raise AssertionError(f"query graph: {row['graph']['launch_calls']} "
                             f"launch calls, eager "
                             f"{row['eager']['launch_calls']}")
    return row


# The C entries an earlier checkout must declare for ``--parent``, by
# source: the designs of this checkout's parent (commit 4f70bbf). Only
# maxsim_packed changed since (token windows and dim slabs); at the shapes
# both take, its plaid_probe, maxsim_packed, kmeans_assign and all-pairs
# maxsim scores must be bit-equal to this checkout's, and its rerank
# (from gathered candidates) and dequant_score are held to the same
# limits.
PARENT_ABI = {
    "plaid_probe": {
        "plaid_probe_launch": "int plaid_probe_launch(const float* q, const "
        "uint8_t* qmask, const float* centroids, const int32_t* codes, const "
        "uint8_t* cmask, const uint8_t* vmask, float* table, float* out, int "
        "Nq, int Lq, int dim, int K, int C, int L, float t_cs, int "
        "global_table, void* stream)"},
    "maxsim_packed": {
        "maxsim_packed_launch": "int maxsim_packed_launch(const float* q, "
        "const uint8_t* qmask, const uint32_t* words, const int32_t* ids, "
        "const uint8_t* dmask, const float* centroids, const float* values, "
        "float* out, int Nq, int Lq, int dim, int S, int Ld, int W, int "
        "bits, void* stream)"},
    "kmeans_assign": {
        "kmeans_assign_launch": "int kmeans_assign_launch(const float* x, "
        "const float* centroids, const uint8_t* kmask, int32_t* assign, "
        "float* best, int B, int N, int K, int dim, void* stream)"},
    "maxsim": {
        "maxsim_launch": "int maxsim_launch(const float* q, const uint8_t* "
        "qmask, const float* d, const uint8_t* dmask, float* out, int Nq, "
        "int Lq, int dim, int Nd, int Ld, void* stream)",
        "maxsim_rerank_launch": "int maxsim_rerank_launch(const float* q, "
        "const uint8_t* qmask, const float* d, const uint8_t* dmask, float* "
        "out, int Nq, int Lq, int dim, int S, int Ld, void* stream)"},
    "dequant_score": {
        "dequant_score_launch": "int dequant_score_launch(const uint32_t* "
        "words, const int32_t* ids, const float* centroids, const float* "
        "values, const float* q, float* out, int M, int Lq, int dim, int W, "
        "int bits, void* stream)"},
}


def parent_kernels(parent):
    """The entries of ``PARENT_ABI`` from an earlier checkout at
    ``parent``, a directory inside this checkout holding its
    ``src/repro_torch/csrc``, built with the same nvcc flags (one process
    per source, started together), as callables on the wrappers'
    arguments (at most 128 query tokens); {} without one. Raises unless
    each source declares its ``PARENT_ABI`` entries."""
    import ctypes
    import re
    import torch
    from repro_torch.kernels import build
    if not parent:
        return {}
    root = os.path.realpath(parent)
    if not root.startswith(os.path.realpath(ROOT) + os.sep):
        raise ValueError(f"--parent {parent}: not a directory inside "
                         f"{ROOT}")
    csrc = os.path.join(root, "src", "repro_torch", "csrc")
    for name, entries in PARENT_ABI.items():
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            text = f.read()
        for fn, want in entries.items():
            decl = re.search(rf'extern "C" (int {fn}\([^)]*\))', text)
            if decl is None or " ".join(decl.group(1).split()) != want:
                raise ValueError(f"--parent {parent}: {name}.cu does not "
                                 f"declare the entry this script calls: "
                                 f"{want}")
    out = os.path.join(ROOT, "build", "parent_kernels")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name in PARENT_ABI:
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the parent's {name} does not build:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    probe = libs["plaid_probe"].plaid_probe_launch
    probe.argtypes = [P] * 8 + [I] * 6 + [ctypes.c_float, I, P]
    table_floats = libs["plaid_probe"].plaid_probe_table_floats
    table_floats.argtypes = [I, I, I]
    table_floats.restype = ctypes.c_size_t
    probe_smem = libs["plaid_probe"].plaid_probe_smem_bytes
    probe_smem.argtypes = [I, I, I]
    probe_smem.restype = ctypes.c_size_t
    packed = libs["maxsim_packed"].maxsim_packed_launch
    packed.argtypes = [P] * 8 + [I] * 7 + [P]
    assign = libs["kmeans_assign"].kmeans_assign_launch
    assign.argtypes = [P] * 5 + [I] * 4 + [P]
    allpairs = libs["maxsim"].maxsim_launch
    allpairs.argtypes = [P] * 5 + [I] * 5 + [P]
    rerank = libs["maxsim"].maxsim_rerank_launch
    rerank.argtypes = [P] * 5 + [I] * 5 + [P]
    dequant = libs["dequant_score"].dequant_score_launch
    dequant.argtypes = [P] * 6 + [I] * 5 + [P]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_probe(q, qm, cen, codes, cm, vm, t_cs):
        from repro_torch.kernels.plaid_probe.ops import probe_route
        (Nq, Lq, dim), (K, _), (_, C, L) = q.shape, cen.shape, codes.shape
        glob = int(probe_route(Lq, K, dim, probe_smem) == "global")
        o = torch.empty((Nq, C), dtype=torch.float32, device=q.device)
        table = torch.empty(table_floats(Nq, Lq, K), dtype=torch.float32,
                            device=q.device)
        build.check(probe(q.data_ptr(), qm.data_ptr(), cen.data_ptr(),
                          codes.data_ptr(), cm.data_ptr(), vm.data_ptr(),
                          table.data_ptr(), o.data_ptr(), Nq, Lq, dim, K, C,
                          L, float(t_cs), glob, stream()),
                    "parent plaid_probe")
        return o

    def run_packed(q, qm, w, a, dm, cen, vals, bits):
        (Nq, Lq, dim), (_, S, Ld, W) = q.shape, w.shape
        o = torch.empty((Nq, S), dtype=torch.float32, device=q.device)
        build.check(packed(q.data_ptr(), qm.data_ptr(), w.data_ptr(),
                           a.data_ptr(), dm.data_ptr(), cen.data_ptr(),
                           vals.data_ptr(), o.data_ptr(), Nq, Lq, dim, S, Ld,
                           W, bits, stream()), "parent maxsim_packed")
        return o

    def run_assign(x, c, km):
        (B, N, dim), K = x.shape, c.shape[1]
        a = torch.empty((B, N), dtype=torch.int32, device=x.device)
        b = torch.empty((B, N), dtype=torch.float32, device=x.device)
        build.check(assign(x.data_ptr(), c.data_ptr(), km.data_ptr(),
                           a.data_ptr(), b.data_ptr(), B, N, K, dim,
                           stream()), "parent kmeans_assign")
        return a, b

    def run_allpairs(q, qm, d, dm):
        (Nq, Lq, dim), (Nd, Ld, _) = q.shape, d.shape
        o = torch.empty((Nq, Nd), dtype=torch.float32, device=q.device)
        build.check(allpairs(q.data_ptr(), qm.data_ptr(), d.data_ptr(),
                             dm.data_ptr(), o.data_ptr(), Nq, Lq, dim, Nd, Ld,
                             stream()), "parent maxsim")
        return o

    def run_rerank(q, qm, d, dm):
        (Nq, Lq, dim), (_, S, Ld, _) = q.shape, d.shape
        o = torch.empty((Nq, S), dtype=torch.float32, device=q.device)
        build.check(rerank(q.data_ptr(), qm.data_ptr(), d.data_ptr(),
                           dm.data_ptr(), o.data_ptr(), Nq, Lq, dim, S, Ld,
                           stream()), "parent maxsim_rerank")
        return o

    def run_dequant(w, cid, cen, vals, q, bits):
        (M, W), (Lq, dim) = w.shape, q.shape
        o = torch.empty((M, Lq), dtype=torch.float32, device=q.device)
        build.check(dequant(w.data_ptr(), cid.data_ptr(), cen.data_ptr(),
                            vals.data_ptr(), q.data_ptr(), o.data_ptr(), M,
                            Lq, dim, W, bits, stream()),
                    "parent dequant_score")
        return o

    return {"plaid_probe": run_probe, "maxsim_packed": run_packed,
            "kmeans_assign": run_assign, "maxsim": run_allpairs,
            "maxsim_rerank": run_rerank, "dequant_score": run_dequant}


def _launches(name):
    by_path = {p: c[name] for p, c in PATH_LAUNCHES.items() if c[name]}
    return dict(launches=sum(by_path.values()), launches_by_path=by_path)


def _allpairs_bound(q, qm, d, dm):
    """Bytes: q, d and their masks read once, the scores written once;
    operations: 2 dim x valid query tokens x valid doc tokens, three passes
    at the TF32 tensor-core rate (-> bound, by, and the f32 bound)."""
    dim = q.shape[2]
    n_bytes = _nbytes(q, qm, d, dm) + q.shape[0] * d.shape[0] * 4
    ops = 2 * dim * int(qm.sum()) * int(dm.sum())
    bound, by = _bound_ms(n_bytes, ops * TF32_PASSES, _hw().PEAK_FLOPS_TF32)
    return bound, by, _bound_ms(n_bytes, ops)[0]


def capture_maxsim_args(torch, searcher, queries):
    """The arguments of the all-pairs ``maxsim`` call of one search batch
    (the flat path's own inputs). Outside every counted run."""
    from repro_torch.kernels.maxsim import ops as mo
    seen = []
    inner = mo.maxsim

    def keep(*args, **kw):
        if not seen:
            seen.append(args)
        return inner(*args, **kw)

    mo.maxsim = keep
    try:
        searcher.search(queries[:QUERY_BATCH], k=TOP_K)
    finally:
        mo.maxsim = inner
    if not seen:
        raise AssertionError("the search batch made no maxsim call")
    return seen[0]


def check_maxsim(torch, dev, index, qv, flat_args, parent):
    """All-pairs kernel at the recon store's full width (Nd = 16,384) and
    at the flat path's own inputs (``flat_args``), each held to the plain
    version; timed beside the parent design where ``parent`` holds it
    (whose scores must be equal), and beside ``torch.matmul`` of the same
    product alone (TF32 off): no port, no library_ms (it leaves out the
    masked maxima and sums)."""
    from repro_torch.kernels.maxsim.ops import maxsim
    d, dm = index._plaid.recon_store().padded()
    dm = dm.clone()
    dm[0] = False                                # an all-masked doc
    Nq, Lq, dim = qv.shape
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False                           # masked query tokens
    cases = {"synthetic": (qv, qm, d, dm), "flat path": flat_args}
    errs, times = [], {}
    for what, args in cases.items():
        got = maxsim(*args)
        want = maxsim(*args, impl="ref")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs.append(err)
        if not torch.allclose(got, want, rtol=1e-5, atol=SCORE_ATOL):
            raise AssertionError(f"maxsim {what}: max abs err {err}")
        dead = ~args[3].any(1)
        if bool(dead.any()) and float(got[:, dead].abs().max()) != 0.0:
            raise AssertionError(f"maxsim {what}: an all-masked doc did not "
                                 f"score 0")
        times[what] = _time_ms(lambda: maxsim(*args))
        if parent:
            if not torch.equal(parent["maxsim"](*args), got):
                raise AssertionError(f"maxsim {what}: differs from the "
                                     f"parent design's scores")
            times[what + " parent"] = _time_ms(lambda: parent["maxsim"](*args))
        del got, want
    # the product alone, [Nq Lq, dim] x [dim, Nd Ld] in f32 (TF32 off)
    mm = {}
    for what, (q, _, dd, _) in cases.items():
        a, b = q.reshape(-1, q.shape[2]), dd.reshape(-1, dd.shape[2])
        buf = torch.empty((a.shape[0], b.shape[0]), device=dev)
        mm[what] = _time_ms(lambda: torch.matmul(a, b.T, out=buf), reps=2)
        del buf
    bound, by, f32_bound = _allpairs_bound(qv, qm, d, dm)
    path_bound, path_by, path_f32 = _allpairs_bound(*flat_args)
    fq, fqm, fd, fdm = flat_args
    print(f"maxsim flat path inputs: Nq={fq.shape[0]}, Lq={fq.shape[1]}, "
          f"Nd={fd.shape[0]}, Ld={fd.shape[1]}, {int(fdm.sum())} valid doc "
          f"tokens; bound {path_bound:.4f} ms ({path_by}; f32 "
          f"{path_f32:.4f})")
    print("maxsim times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + "; torch.matmul of the "
        "product alone (f32, TF32 off; for reference, no port): " + ", ".join(
            f"{k} {v:.4f}" for k, v in mm.items())
        + f"; {_hmma_count('maxsim')}")
    return dict(name="maxsim", route="cuda",
                source="src/repro_torch/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim/kernel.py:42",
                **_launches("maxsim"), max_abs_err=max(errs),
                ms=times["synthetic"],
                plain_ms=_time_ms(lambda: maxsim(*cases["synthetic"],
                                                 impl="ref"), reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                f32_bound_ms=f32_bound, path_ms=times["flat path"],
                path_bound_ms=path_bound,
                parent_ms=times.get("synthetic parent"),
                parent_path_ms=times.get("flat path parent"),
                matmul_ms=mm["synthetic"], path_matmul_ms=mm["flat path"],
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL}, all-masked doc "
                      f"0 (Nq={Nq}, Lq={Lq} with 2 masked, Nd={d.shape[0]}, "
                      f"Ld={d.shape[1]}; and the flat path's own inputs"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: products at 3 passes of the TF32 rate "
                      f"(f32 bound {f32_bound:.4f} ms); library_ms "
                      f"{NO_LIBRARY}")


def _rerank_bound(q, qm, pair_dm, read_dm, n_slots):
    """Bytes: q and its mask, the doc masks read (``read_dm``) and their
    valid rows, 8 + 1 bytes a slot of ids and flags where the layout has
    them (``n_slots``), the scores; operations: 2 dim x valid query tokens
    x each query's valid candidate rows (``pair_dm`` [Nq, S, Ld]), three
    passes at the TF32 tensor-core rate."""
    dim = q.shape[2]
    n_bytes = (_nbytes(q, qm, read_dm) + int(read_dm.sum()) * dim * 4
               + n_slots * 9 + pair_dm.shape[0] * pair_dm.shape[1] * 4)
    ops = 2 * dim * int((qm.sum(1)[:, None] * pair_dm.sum(2)).sum())
    return _bound_ms(n_bytes, ops * TF32_PASSES, _hw().PEAK_FLOPS_TF32)


def check_maxsim_rerank(torch, dev, index, qv, recon_args, cascade_args,
                        parent):
    """The gathered entry at one slab of the recon store (S = 1,024 random
    candidates a query, 19 in 20 valid), and the indexed entry at the
    recon_rerank path's own slate (``recon_args``, one batch's arguments)
    and at the cascade's stage 2 (``cascade_args``), each held to its
    plain version. Where ``parent`` holds the parent design (the f32 FMA
    rerank of gathered candidates) it is held to the same limits and
    timed on the same inputs, at the slates with the gather it needs
    (``DocStore.gather``'s ``d[cand]``) inside its time."""
    from repro_torch.kernels.maxsim.ops import (maxsim_rerank,
                                                maxsim_rerank_indexed)
    store = index._plaid.recon_store()
    Nq, Lq, dim = qv.shape
    S = 1024
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    cand = torch.randint(0, index.n_docs, (Nq, S), generator=g, device=dev)
    cm = torch.rand((Nq, S), generator=g, device=dev) < 0.95
    d, dm = store.gather(cand)
    dm = dm & cm[:, :, None]
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    qm[:, -2:] = False
    errs, times = [], {}

    def hold(what, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs.append(err)
        if not torch.allclose(got, want, rtol=1e-5, atol=SCORE_ATOL):
            raise AssertionError(f"maxsim_rerank {what}: max abs err {err}")

    syn = (qv, qm, d, dm)
    want = maxsim_rerank(*syn, impl="ref")
    hold("synthetic", maxsim_rerank(*syn), want)
    times["synthetic"] = _time_ms(lambda: maxsim_rerank(*syn))
    if parent:
        hold("synthetic, parent design", parent["maxsim_rerank"](*syn), want)
        times["synthetic parent"] = _time_ms(
            lambda: parent["maxsim_rerank"](*syn))
    slates, path = {}, {}
    for what, args in (("recon", recon_args), ("cascade", cascade_args)):
        pq, pqm, pd, pdm, pc, pcm = args
        want = maxsim_rerank_indexed(*args, impl="ref")
        hold(what, maxsim_rerank_indexed(*args), want)
        times[what] = _time_ms(lambda: maxsim_rerank_indexed(*args))
        if parent:
            def gathered():                   # the parent's way: gather, score
                c = torch.where(pcm, pc, torch.zeros_like(pc))
                return parent["maxsim_rerank"](pq, pqm, pd[c],
                                               pdm[c] & pcm[:, :, None])
            hold(f"{what}, parent design", gathered(), want)
            times[what + " parent (gather + kernel)"] = _time_ms(gathered)
        # the rows each query's valid candidates hold, and the distinct
        # candidates' (read once: the guide's bound) against all pairs'
        sdm = pdm[torch.where(pcm, pc, torch.zeros_like(pc))] & pcm[:, :, None]
        distinct = torch.unique(pc[pcm])
        path[what] = dict(
            ms=times[what],
            bound_ms=_rerank_bound(pq, pqm, sdm, pdm[distinct],
                                   pc.numel())[0],
            pairs_bound_ms=_rerank_bound(pq, pqm, sdm, sdm, pc.numel())[0],
            parent_ms=times.get(what + " parent (gather + kernel)"))
        slates[what] = (f"{what}: Nq={pq.shape[0]}, Lq={pq.shape[1]}, "
                        f"S={pc.shape[1]}, {int(pcm.sum())} valid candidates "
                        f"({distinct.numel()} distinct) of {pd.shape[0]} "
                        f"docs, Ld={pd.shape[1]}, {int(sdm.sum())} valid rows "
                        f"of all pairs, {int(pdm[distinct].sum())} of the "
                        f"distinct candidates; bound "
                        f"{path[what]['bound_ms']:.4f} ms (distinct rows "
                        f"read once), "
                        f"{path[what]['pairs_bound_ms']:.4f} ms (every "
                        f"pair's rows)")
    bound, by = _rerank_bound(qv, qm, dm, dm, 0)
    print("maxsim_rerank slates: " + "; ".join(slates.values()))
    print("maxsim_rerank times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items())
        + f"; {_hmma_count('maxsim', 'maxsim_tc_kernel')}")
    return dict(name="maxsim_rerank", route="cuda",
                source="src/repro_torch/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim/kernel.py:85",
                **_launches("maxsim_rerank"), max_abs_err=max(errs),
                ms=times["synthetic"],
                plain_ms=_time_ms(lambda: maxsim_rerank(*syn, impl="ref"),
                                  reps=2),
                bound_ms=bound, bound_by=by, library_ms=None,
                parent_ms=times.get("synthetic parent"), slates_ms=path,
                times_ms=times,
                check=f"allclose rtol 1e-5 atol {SCORE_ATOL} (gathered: "
                      f"Nq={Nq}, Lq={Lq} with 2 masked, S={S}, "
                      f"Ld={d.shape[2]}; indexed: the recon_rerank and "
                      f"cascade slates"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: the valid rows read once, products at 3 "
                      f"passes of the TF32 rate; library_ms {NO_LIBRARY}")


def _assign_hold(what, torch, x, c, km, valid, got, want):
    """Ids equal to the plain version's except on rows whose top two sims
    lie within NEAR_TIE, best sims allclose rtol 1e-5 atol 1e-5;
    -> (rows that differ, valid near-tie rows, max abs err of best)."""
    got_a, got_s = got
    want_a, want_s = want
    sim = torch.bmm(x, c.transpose(1, 2)).masked_fill(~km[:, None, :],
                                                      float("-inf"))
    top2 = sim.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE
    differ = got_a != want_a
    n_near, n_differ = int((near & valid).sum()), int(differ.sum())
    bad = int((differ & ~near).sum())
    err = float((got_s - want_s).abs().max())
    print(f"kmeans_assign {what}: {n_differ} of {got_a.numel()} rows differ "
          f"from the plain version, {n_near} valid rows have their top two "
          f"sims within {NEAR_TIE}; rows that differ off a near tie: {bad}; "
          f"best max abs err {err:.3g}")
    if bad:
        raise AssertionError(f"kmeans_assign {what}: {bad} rows differ off a "
                             f"near tie")
    if not torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"kmeans_assign {what}: best sims max abs err "
                             f"{err}")
    return n_differ, n_near, err


def check_kmeans_assign(torch, dev, model, docs, parent):
    """At the k-means path's shapes: its first encode batch (B = 128,
    N = 256, d = 128) against its centroids after the last Lloyd step
    (K = 129), and at that shape on random unit vectors (the synthetic
    case). Timed at the path's inputs beside the parent design where
    ``parent`` holds it (whose ids and sims must be equal), and beside
    ``torch.matmul`` of the product alone (TF32 off; no port)."""
    from repro_torch.core.kmeans import kmeans_fit_batch
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    from repro_torch.models.colbert import encode_docs
    v, emit = encode_docs(model, docs[:ENCODE_BATCH])
    B, N, d = v.shape
    x, c, km = kmeans_fit_batch(v, emit, emit.sum(-1) // 2 + 1, N // 2 + 1)
    K = c.shape[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    xs = torch.randn((B, N, d), generator=g, device=dev)
    cs = torch.randn((B, K, d), generator=g, device=dev)
    xs, cs = xs / xs.norm(dim=-1, keepdim=True), cs / cs.norm(dim=-1,
                                                              keepdim=True)
    kms = torch.arange(K, device=dev)[None] < torch.randint(
        K // 2, K + 1, (B, 1), generator=g, device=dev)
    cases = {"path": (x, c, km, emit),
             "synthetic": (xs, cs, kms, torch.ones_like(emit))}
    held, errs, times = {}, [], {}
    for what, (xx, cc, kk, valid) in cases.items():
        want = kmeans_assign(xx, cc, kk, impl="ref")
        got = kmeans_assign(xx, cc, kk)
        n_differ, n_near, err = _assign_hold(what, torch, xx, cc, kk, valid,
                                             got, want)
        held[what] = f"{n_differ} differ, {n_near} valid near-tie rows"
        errs.append(err)
        times[what] = _time_ms(lambda: kmeans_assign(xx, cc, kk))
        if parent:
            pa, pb = parent["kmeans_assign"](xx, cc, kk)
            if not (torch.equal(pa, got[0]) and torch.equal(pb, got[1])):
                raise AssertionError(f"kmeans_assign {what}: differs from "
                                     f"the parent design's")
            times[what + " parent"] = _time_ms(
                lambda: parent["kmeans_assign"](xx, cc, kk))
    ct = c.transpose(1, 2)
    mm_ms = _time_ms(lambda: torch.matmul(x, ct))
    # bytes: x, the centroids and k_mask read once, ids and best written
    # once; operations: valid clusters only, three TF32 passes
    n_bytes = _nbytes(x, c, km) + B * N * 8
    ops = 2 * d * N * int(km.sum())
    bound, by = _bound_ms(n_bytes, ops * TF32_PASSES, _hw().PEAK_FLOPS_TF32)
    f32_bound = _bound_ms(n_bytes, ops)[0]
    print("kmeans_assign times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f"; torch.matmul of the "
        f"product alone (f32, TF32 off; for reference, no port) "
        f"{mm_ms:.4f}; bound {bound:.4f} ({by}; f32 {f32_bound:.4f}); "
        f"{_hmma_count('kmeans_assign')}")
    return dict(name="kmeans_assign", route="cuda",
                source="src/repro_torch/csrc/kmeans_assign.cu",
                replaces="src/repro/kernels/kmeans_assign/kernel.py:36",
                **_launches("kmeans_assign"), max_abs_err=max(errs),
                ms=times["path"],
                plain_ms=_time_ms(lambda: kmeans_assign(x, c, km,
                                                        impl="ref")),
                bound_ms=bound, bound_by=by, library_ms=None,
                f32_bound_ms=f32_bound, synthetic_ms=times["synthetic"],
                parent_ms=times.get("path parent"),
                parent_synthetic_ms=times.get("synthetic parent"),
                matmul_ms=mm_ms,
                check=f"ids equal off near ties, best allclose rtol 1e-5 "
                      f"atol 1e-5 at the path's first batch ({held['path']})"
                      f" and on random unit vectors ({held['synthetic']}) "
                      f"(B={B}, N={N}, K={K}, d={d}"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: x, centroids read once, products at 3 passes "
                      f"of the TF32 rate; library_ms null: a matmul plus a "
                      f"masked argmax is not one call")


def check_dequant_score(torch, dev, index, qv, parent):
    """On the main index's rows: the packed tokens of every candidate doc
    of the first query batch, scored against one query's tokens; held to
    the plain version and, per document, to ``maxsim_packed``. Where
    ``parent`` holds the parent design (f32 FMA) it is held to the same
    limits and timed on the same inputs."""
    from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
    from repro_torch.kernels.quant.ops import dequant_score
    p = index._plaid
    cand, cmask = index.candidates(qv)
    docs = torch.unique(cand[cmask])
    ids, words, tmask = p.padded_packed()
    dm = tmask[docs]
    w, cid = words[docs][dm].contiguous(), ids[docs][dm].contiguous()
    row_doc = torch.arange(len(docs), device=dev)[:, None].expand_as(dm)[dm]
    q = qv[0].contiguous()
    Lq, dim = q.shape
    M, bits = w.shape[0], p.codec.bits
    cen, vals = p.codec.centroids.contiguous(), p.codec.values.contiguous()
    args = (w, cid, cen, vals, q)
    got = dequant_score(*args, bits=bits)
    want = dequant_score(*args, bits=bits, impl="ref")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=0, atol=SCORE_ATOL):
        raise AssertionError(f"dequant_score: max abs err {err}")
    best = torch.full((len(docs), Lq), float("-inf"), device=dev)
    best = best.scatter_reduce(0, row_doc[:, None].expand(M, Lq), got,
                               "amax")
    qm = torch.ones((1, Lq), dtype=torch.bool, device=dev)
    packed = maxsim_packed_rerank(q[None], qm, words[docs][None],
                                  ids[docs][None], dm[None], cen, vals,
                                  bits=bits)[0]
    doc_err = float((best.sum(1) - packed).abs().max())
    if not torch.allclose(best.sum(1), packed, rtol=0, atol=SCORE_ATOL):
        raise AssertionError(f"dequant_score: per-doc MaxSim differs from "
                             f"maxsim_packed by {doc_err}")
    times = {"new": _time_ms(lambda: dequant_score(*args, bits=bits))}
    if parent:
        perr = float((parent["dequant_score"](*args, bits) - want).abs().max())
        if perr > SCORE_ATOL:
            raise AssertionError(f"dequant_score, parent design: max abs err "
                                 f"{perr}")
        times["parent"] = _time_ms(lambda: parent["dequant_score"](*args,
                                                                   bits))
    # operations: the products at 3 passes of the TF32 rate, the
    # reconstruction's ~4 dim a row at f32
    ops = [(M * 2 * Lq * dim * TF32_PASSES, _hw().PEAK_FLOPS_TF32)]
    out_bytes = M * Lq * 4
    bound, by = _bound_ms(_nbytes(*args) + out_bytes, M * 4 * dim,
                          more=ops)
    rows_bound, rows_by = _bound_ms(_nbytes(w, cid, vals, q) + M * dim * 4
                                    + out_bytes, M * 4 * dim, more=ops)
    print("dequant_score times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items())
        + f"; {_hmma_count('dequant_score')}")
    return dict(name="dequant_score", route="cuda",
                source="src/repro_torch/csrc/dequant_score.cu",
                replaces="src/repro/kernels/quant/kernel.py:62",
                **_launches("dequant_score"), max_abs_err=err,
                ms=times["new"],
                plain_ms=_time_ms(lambda: dequant_score(*args, bits=bits,
                                                        impl="ref")),
                bound_ms=bound, bound_by=by, library_ms=None,
                parent_ms=times.get("parent"),
                check=f"allclose atol {SCORE_ATOL}; per-doc max summed over "
                      f"the query equals maxsim_packed to {SCORE_ATOL} (max "
                      f"diff {doc_err:.3g}) (M={M} rows of {len(docs)} "
                      f"candidate docs, Lq={Lq}, dim={dim}, b={bits}"
                      f"{'; the parent design too' if parent else ''}); "
                      f"bound: products at 3 passes of the TF32 rate, "
                      f"reconstruction at f32; with a centroid row read per "
                      f"row {rows_bound:.4f} ms ({rows_by}); launches 0: no "
                      f"path of the JAX package calls it; library_ms null: "
                      f"unpack + reconstruct + score is not one call")


def _errors(got, want):
    """Max abs and relative (Frobenius) error of got against want."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max()),
            float((got - want).norm() / want.norm()))


def _compare(what, got, want, atol, rel):
    """Prints the errors of got against want; raises past atol or rel."""
    err, r = _errors(got, want)
    print(f"{what}: max abs err {err:.4g} (atol {atol}), relative "
          f"{r:.4g} (limit {rel})")
    if err > atol or r > rel:
        raise AssertionError(f"{what}: the kernel path and the plain path "
                             f"disagree")


def _cache_errors(cache, want, S):
    """-> (max abs difference of layer 0's k and v, which no attention
    has touched; the largest relative error of one layer's k or v over
    the layers after it)."""
    first, worst = 0.0, 0.0
    for key in ("k", "v"):
        for layer in range(cache[key].shape[0]):
            err, r = _errors(cache[key][layer, :, :S], want[key][layer, :, :S])
            if layer == 0:
                first = max(first, err)
            else:
                worst = max(worst, r)
    return first, worst


@contextlib.contextmanager
def _flash_replaced(make):
    """The model's call of the ``flash_attention`` wrapper goes through
    ``make(wrapper)`` for the duration."""
    import repro_torch.models.attention as att
    inner = att.flash_attention
    att.flash_attention = make(inner)
    try:
        yield
    finally:
        att.flash_attention = inner


def _capturing(layers, store):
    """A replacement that passes every call through and keeps the q, k,
    v and output of the given layers' calls (in call order)."""
    def make(inner):
        calls = [0]

        def wrapped(q, k, v, **kw):
            o = inner(q, k, v, **kw)
            if calls[0] in layers:
                store[calls[0]] = (q, k, v, o)
            calls[0] += 1
            return o
        return wrapped
    return make


def _planted(fault):
    """A replacement that calls the kernel with one fault planted."""
    def make(inner):
        def wrapped(q, k, v, causal=True, **kw):
            if fault == "causal=False":
                return inner(q, k, v, causal=False, **kw)
            if fault == "kv head h % KV, not h // G":
                G = q.shape[1] // k.shape[1]
                return inner(q, k.repeat(1, G, 1, 1), v.repeat(1, G, 1, 1),
                             causal=causal, **kw)
            if fault == "diagonal off by one":   # row i sees columns < i
                return inner(q, k[:, :, :-1], v[:, :, :-1], causal=causal,
                             **kw)
            raise ValueError(fault)
        return wrapped
    return make


def _check_captured(what, torch, captured):
    """Each captured layer's kernel output against the plain version on
    the same q, k, v (the model's own, at the path's shape)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    tol = FLASH_TOL["bfloat16"]
    for layer, (q, k, v, o) in sorted(captured.items()):
        want = flash_attention(q, k, v, causal=True, impl="ref").float()
        err = float((o.float() - want).abs().max())
        FLASH_ERRS.append(err)
        print(f"{what}: layer {layer}'s own q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)}: kernel vs plain version max abs err "
              f"{err:.4g} (atol = rtol = {tol})")
        if not torch.allclose(o.float(), want, rtol=tol, atol=tol):
            raise AssertionError(f"{what}: flash_attention disagrees with "
                                 f"its plain version at layer {layer}")
        del want


def _lm_model(rt, torch):
    cfg = dataclasses.replace(rt.get_config(LM_ARCH), use_flash_kernel=True)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{LM_ARCH}: compute dtype {cfg.dtype}")
    t0 = time.perf_counter()
    model = rt.init_transformer(cfg, seed=SEED)
    torch.cuda.synchronize()
    print(f"lm setup: {LM_ARCH} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"kv heads, d_head {cfg.d_head}, vocab {cfg.vocab_size}; "
          f"{sum(p.numel() for p in model.parameters())} params, random "
          f"from seed {SEED}) in {time.perf_counter() - t0:.3f}s")
    return cfg, model


def _serve(rt, torch, cfg, model, tokens, n_decode):
    """Prefill through the step builder, then ``n_decode`` greedy decode
    steps; -> (logits per position [n_decode + 1] x [B, V] f32, greedy
    tokens [B, n_decode + 1], cache, prefill s, decode s)."""
    from repro_torch.kernels import launch_counts
    B, S = tokens.shape
    prefill = rt.make_lm_prefill_step(cfg, max_len=S + n_decode)
    decode = rt.make_lm_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = launch_counts()["flash_attention"]
    out, toks = [logits.float()], [logits.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(n_decode):
        logits, cache = decode(model, cache, {"token": toks[-1][:, None],
                                              "pos": S + i})
        out.append(logits.float())
        toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if launch_counts()["flash_attention"] != after_prefill:
        raise AssertionError("a decode step launched flash_attention")
    return out, torch.stack(toks, 1), cache, prefill_s, decode_s


def _check_cache(what, cache, want, S):
    first, worst = _cache_errors(cache, want, S)
    print(f"{what} cache [:, :, :{S}]: layer 0 max abs difference {first:.4g}"
          f" (computed before any attention); layers 1.. largest relative "
          f"error of one layer's k or v {worst:.4g} (limit {LM_REL})")
    if worst > LM_REL:
        raise AssertionError(f"{what}: the kernel path's cache and the "
                             f"plain path's disagree")


def lm_faults(rt, torch, cfg, model, tokens, p_logits, p_cache):
    """The kernel path's prefill again with each of LM_FAULTS planted;
    each must break a limit that the lm path holds the kernel path to."""
    S = tokens.shape[1]
    for fault in LM_FAULTS:
        with _flash_replaced(_planted(fault)):
            logits, _, cache, _, _ = _serve(rt, torch, cfg, model, tokens, 0)
        err, r = _errors(logits[0], p_logits[0])
        _, worst = _cache_errors(cache, p_cache, S)
        del logits, cache
        caught = err > LM_LOGITS_ATOL or r > LM_REL or worst > LM_REL
        print(f"lm planted fault ({fault}): last-token logits max abs err "
              f"{err:.4g} (atol {LM_LOGITS_ATOL}), relative {r:.4g} (limit "
              f"{LM_REL}); cache layers 1.. largest relative {worst:.4g} "
              f"(limit {LM_REL}); caught: {caught}")
        if not caught:
            raise AssertionError(f"lm: the limits do not catch the planted "
                                 f"fault {fault!r}")


def lm_path(rt, torch, cfg, model):
    """Qwen3-0.6B serving: prefill of 8 x 2,048 tokens and 16 greedy
    decode steps through the kernel path, then the plain path."""
    from repro_torch.kernels import launch_counts
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    logits, toks, cache, prefill_s, decode_s = run_path(
        "lm", torch, lambda: _serve(rt, torch, cfg, model, tokens,
                                    LM_DECODE))
    peak = torch.cuda.max_memory_allocated()
    n = PATH_LAUNCHES["lm"]["flash_attention"]
    print(f"lm: flash_attention launches {n} (one a layer: "
          f"{n == cfg.n_layers}), none in the {LM_DECODE} decode steps")
    if n != cfg.n_layers:
        raise AssertionError(f"lm: {n} flash_attention launches, not "
                             f"{cfg.n_layers}")
    n_tok = LM_BATCH * LM_PROMPT
    print(f"lm: first pass prefill {prefill_s:.4f}s ({n_tok / prefill_s:.1f}"
          f" tokens/s), decode {decode_s / LM_DECODE * 1e3:.3f} ms a step "
          f"(batch {LM_BATCH}); peak device memory {peak} bytes")
    for x in logits:
        if tuple(x.shape) != (LM_BATCH, cfg.vocab_size) or not bool(
                torch.isfinite(x).all()):
            raise AssertionError("lm: logits of the wrong shape or not "
                                 "finite")
    # steady: the kernel path's prefill and decode again, keeping the
    # first and the last layer's kernel inputs and outputs
    captured = {}
    with _flash_replaced(_capturing((0, cfg.n_layers - 1), captured)):
        again, _, _, prefill_s, decode_s = _serve(rt, torch, cfg, model,
                                                  tokens, LM_DECODE)
    print(f"lm: steady prefill {prefill_s:.4f}s ({n_tok / prefill_s:.1f} "
          f"tokens/s), decode {decode_s / LM_DECODE * 1e3:.3f} ms a step")
    del again
    _check_captured("lm", torch, captured)
    del captured
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    before = launch_counts()["flash_attention"]
    p_logits, p_toks, p_cache, p_prefill_s, p_decode_s = _serve(
        rt, torch, plain, model, tokens, LM_DECODE)
    if launch_counts()["flash_attention"] != before:
        raise AssertionError("the plain path launched flash_attention")
    print(f"lm: plain path prefill {p_prefill_s:.4f}s "
          f"({n_tok / p_prefill_s:.1f} tokens/s), decode "
          f"{p_decode_s / LM_DECODE * 1e3:.3f} ms a step")
    _compare("lm last-token logits", logits[0], p_logits[0], LM_LOGITS_ATOL,
             LM_REL)
    _check_cache("lm", cache, p_cache, LM_PROMPT)
    _greedy_agree(logits, toks, p_logits, p_toks)
    del cache
    lm_faults(rt, torch, cfg, model, tokens, p_logits, p_cache)


def _greedy_agree(logits, toks, p_logits, p_toks):
    """Per sequence, positions up to the first differing token are fed
    the same tokens: their logits must agree to LM_LOGITS_ATOL and their
    tokens must be equal unless the plain path's top-2 gap is within
    LM_LOGITS_ATOL; after such a (legitimate) split the inputs differ
    and nothing more is compared."""
    B, n = toks.shape
    t, pt = toks.cpu().numpy(), p_toks.cpu().numpy()
    worst, splits = 0.0, []
    for b in range(B):
        for j in range(n):
            worst = max(worst, float((logits[j][b] - p_logits[j][b]).abs()
                                     .max()))
            if t[b, j] != pt[b, j]:
                top2 = p_logits[j][b].topk(2).values
                gap = float(top2[0] - top2[1])
                splits.append((b, j, gap))
                if gap > LM_LOGITS_ATOL:
                    raise AssertionError(
                        f"lm: greedy token {j} of sequence {b} differs "
                        f"where the plain path's top-2 gap is {gap:.4g}")
                break
    print(f"lm greedy decode: {B} sequences x {n} tokens; logits where the "
          f"inputs agree max abs err {worst:.4g} (atol {LM_LOGITS_ATOL}); "
          f"splits (sequence, token, plain top-2 gap): {splits}")
    if worst > LM_LOGITS_ATOL:
        raise AssertionError("lm: decode logits disagree")


def lm_long_path(rt, torch, cfg, model):
    """The same model at B = 1, S = 8,192, prefill only; the plain path
    there is the chunked online-softmax attention."""
    tokens = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, LM_LONG)).astype(np.int32)
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    if not (LM_LONG > plain.attn_full_threshold
            and LM_LONG % plain.attn_chunk == 0):
        raise AssertionError("lm_long: the plain path is not the chunked one")
    torch.cuda.reset_peak_memory_stats()
    logits, _, cache, prefill_s, _ = run_path(
        "lm_long", torch, lambda: _serve(rt, torch, cfg, model, tokens, 0))
    n = PATH_LAUNCHES["lm_long"]["flash_attention"]
    print(f"lm_long: flash_attention launches {n}; prefill {prefill_s:.4f}s "
          f"({LM_LONG / prefill_s:.1f} tokens/s); peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    if n != cfg.n_layers:
        raise AssertionError(f"lm_long: {n} flash_attention launches, not "
                             f"{cfg.n_layers}")
    captured = {}
    with _flash_replaced(_capturing((0, cfg.n_layers - 1), captured)):
        again = _serve(rt, torch, cfg, model, tokens, 0)
    del again
    _check_captured("lm_long", torch, captured)
    del captured
    p_logits, _, p_cache, p_prefill_s, _ = _serve(rt, torch, plain, model,
                                                  tokens, 0)
    print(f"lm_long: plain (chunked) path prefill {p_prefill_s:.4f}s")
    if not bool(torch.isfinite(logits[0]).all()):
        raise AssertionError("lm_long: non-finite logits")
    _compare("lm_long last-token logits", logits[0], p_logits[0],
             LM_LOGITS_ATOL, LM_REL)
    _check_cache("lm_long", cache, p_cache, LM_LONG)


def _params_equal(torch, a, b):
    """(bitwise equal, max abs difference) of two parameter lists."""
    diff = max(float((x - y).abs().max().detach()) for x, y in zip(a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b)), diff


def _train_batches(cfg):
    """``examples/train_colbert.py``'s pairs (``train_pairs(steps x
    batch, seed=1)`` of scidocs), the queries at query_maxlen - 2 ids and
    the positive docs at the full doc_maxlen - 2 (the example's 64 cut
    to size for a CPU)."""
    from repro_torch.data.corpus import DATASET_SPECS, SyntheticRetrievalCorpus
    corpus = SyntheticRetrievalCorpus(DATASET_SPECS[CT_TRAIN_DATASET],
                                      vocab_size=cfg.trunk.vocab_size)
    qs, ds = corpus.train_pairs(CT_STEPS * CT_BATCH, seed=1)
    qlen, dlen = cfg.query_maxlen - 2, cfg.doc_maxlen - 2
    out = []
    for s in range(CT_STEPS):
        q = np.zeros((CT_BATCH, qlen), np.int32)
        d = np.zeros((CT_BATCH, dlen), np.int32)
        for b in range(CT_BATCH):
            qq = qs[s * CT_BATCH + b][:qlen]
            dd = corpus.docs[ds[s * CT_BATCH + b]][:dlen]
            q[b, :len(qq)], d[b, :len(dd)] = qq, dd
        out.append({"q": q, "d": d})
    return out


def _grads_all_finite(what, torch, model, loss):
    """Every parameter gets a gradient (not None) and it is finite."""
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    missing = [n for n, g in zip(names, grads) if g is None]
    bad = [n for n, g in zip(names, grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    print(f"{what}: {len(names)} parameters, gradients missing "
          f"{len(missing)}, non-finite {len(bad)}")
    if missing or bad:
        raise AssertionError(f"{what}: gradients missing {missing[:5]} or "
                             f"non-finite {bad[:5]}")


def _sweep(rt, torch, dev, model, ds):
    from repro_torch.eval import QualitySweep
    t0 = time.perf_counter()
    rep = QualitySweep(model, ds, methods=("ward",), factors=CT_FACTORS,
                       backends=("plaid",), quant_bits=(2,),
                       metrics=("ndcg@10",), k=TOP_K, device=dev).run()
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def _sweep_plain(rt, torch, dev, model, ds, rep):
    """The sweep's kernels against their plain versions on the trained
    encoder's own inputs. Ward: every encode batch of the corpus at each
    factor, each doc's assignments equal to the plain version's or
    tie-equivalent (``ward_agree``: as many clusters, an equal Ward
    objective). Search: each cell rebuilt through ``Indexer`` with the
    kernels (the sweep's own calls: its metrics exactly), then searched
    with the kernels and with the plain versions (``impl="ref"``) on that
    index: rankings equal tie-aware, metrics equal but for rankings that
    differ by ties (each moves the mean by one query's share). A build
    on the plain versions is printed beside it: a tie broken the other
    way in one doc moves the codec's centroids, so it is a reading."""
    from repro_torch.eval import compute_metrics
    from repro_torch.kernels.ward_pool.ops import ward_assign
    from repro_torch.kernels.ward_pool.ref import ward_agree, ward_objective
    from repro_torch.retrieval.indexer import EncodedDocs
    cfg = model.cfg
    enc = EncodedDocs.encode(model, ds.doc_tokens, 64)
    for f in CT_FACTORS[1:]:
        n_docs = n_equal = n_tied = 0
        worst = 0.0
        for v, emit, n_real in enc.batches:
            got = ward_assign(v, emit, f)
            want = ward_assign(v, emit, f, impl="ref")
            ow = ward_objective(v, emit, want)
            eq = (got == want).all(-1)[:n_real]
            ok = ward_agree(v, emit, got, want,
                            atol=WARD_OBJ_RTOL * ow)[:n_real]
            gap = (ward_objective(v, emit, got) - ow).abs() / ow.clamp(
                min=1e-30)
            worst = max(worst, float(gap[:n_real].max()))
            n_docs += n_real
            n_equal += int(eq.sum())
            n_tied += int((ok & ~eq).sum())
            if not bool(ok.all()):
                raise AssertionError(f"colbert_train: ward_pool f={f} "
                                     f"disagrees with its plain version")
        print(f"colbert_train ward_pool f={f} on the trained encoder's "
              f"{n_docs} docs: {n_equal} equal to the plain version, "
              f"{n_tied} tie-equivalent (as many clusters, Ward objectives "
              f"within {WARD_OBJ_RTOL} relative; largest {worst:.3g})")
    cells = {c.factor: c for c in rep.cells}
    for f in CT_FACTORS:
        got = {}
        for build_impl in ("auto", "ref"):
            indexer = rt.Indexer(
                model, index_spec=rt.IndexSpec.from_config(
                    cfg, backend="plaid", quant_bits=2),
                pooling_spec=rt.PoolingSpec("ward" if f > 1 else "none", f),
                encode_batch=64, device=dev)
            index, _ = indexer.build(enc, impl=build_impl)
            searcher = rt.Searcher(model, index, encode_batch=64)
            for impl in (("auto", "ref") if build_impl == "auto"
                         else ("ref",)):
                S, I = searcher.search(ds.query_tokens, k=TOP_K, impl=impl)
                got[build_impl, impl] = (S, I, compute_metrics(
                    I, ds.qrels, ("ndcg@10",), device=dev)["ndcg@10"])
        (S, I, v), (S1, I1, v1) = got["auto", "auto"], got["auto", "ref"]
        _agree(f"colbert_train sweep f={f} vs plain versions", S, I, S1, I1)
        swapped = int((I != I1).any(1).sum())
        want = cells[f].metrics["ndcg@10"]
        print(f"colbert_train sweep f={f}: ndcg@10 sweep {want:.6f}, "
              f"rebuilt {v:.6f}, searched on the plain versions {v1:.6f} "
              f"({swapped} queries' rankings differ by ties); built and "
              f"searched on the plain versions {got['ref', 'ref'][2]:.6f}")
        if abs(v - want) > 1e-9:
            raise AssertionError(f"colbert_train: f={f} rebuilt {v} against "
                                 f"the sweep's {want}")
        if abs(v1 - v) > 1e-6 + swapped / ds.n_queries:
            raise AssertionError(f"colbert_train: f={f} plain versions "
                                 f"{v1} against {v}")


def _mean_token_cos(torch, model, ds):
    """Mean cosine of two emitting tokens of one doc, over the docs: how
    far the encoder has collapsed a document onto one vector."""
    from repro_torch.core.ward import normalize_masked
    from repro_torch.retrieval.indexer import EncodedDocs
    cos = []
    for v, emit, n_real in EncodedDocs.encode(model, ds.doc_tokens,
                                              64).batches:
        u = normalize_masked(v, emit)
        pair = emit[:, :, None] & emit[:, None, :] & ~torch.eye(
            emit.shape[1], dtype=torch.bool, device=emit.device)
        c = (u @ u.transpose(1, 2)).masked_fill(~pair, 0.0)
        cos.append((c.sum((1, 2)) / pair.sum((1, 2)).clamp(min=1))[:n_real])
    return float(torch.cat(cos).mean())


def _profile_step(torch, what, step, host_ops=True):
    """One ``step()`` under ``torch.profiler``: wall ms, device busy ms
    (the device activities' time, as ``search_split`` sums it; one
    stream), the idle share and the kernels with the most device time.
    ``host_ops=False``: the device's activities alone (the host ops of
    DTensor's dispatch in a step over a mesh take the profiler tens of
    seconds to gather)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    host_ops = host_ops or not torch.cuda.is_available()  # a CPU rehearsal
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        n_kernels += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{what}: one step under the profiler {wall:.3f} ms wall, "
          f"{n_kernels} device activities, busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.3f}); most device time (ms): " + "; ".join(
              f"{k[:70]} {v:.3f}" for k, v in top))
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                n_device_activities=n_kernels)


def colbert_train_path(rt, torch, dev, card):
    """``examples/train_colbert.py`` at full ColBERTv2 width: 200 AdamW
    steps of 32 pairs under the example's cosine schedule through the
    ``Trainer``, checkpointed at step 100; a second ``Trainer`` restores
    step 100 and runs to 200 again; then ``QualitySweep`` (Ward, f = 1-4,
    plaid, ndcg@10 over scifact) with the trained encoder, re-run with
    the plain versions, and at the step-0 weights as a reading."""
    from repro_torch.eval import synthetic_dataset
    from repro_torch.train import TrainConfig, Trainer
    cfg = rt.CONFIG
    if not cfg.trunk.remat or cfg.trunk.dtype != "bfloat16":
        raise AssertionError("colbert_train: ColBERTv2 trains with remat "
                             "in bf16")
    t0 = time.perf_counter()
    batches = _train_batches(cfg)
    model = rt.init_colbert(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"colbert_train setup: {CT_STEPS} batches of {CT_BATCH} "
          f"{CT_TRAIN_DATASET} pairs (queries {batches[0]['q'].shape[1]}, "
          f"docs {batches[0]['d'].shape[1]} ids) and ColBERTv2 "
          f"({n_params} params) in {time.perf_counter() - t0:.3f}s")
    loss, _ = rt.colbert_loss(model, batches[0]["q"], batches[0]["d"])
    _grads_all_finite("colbert_train first step", torch, model, loss)
    del loss
    ds = synthetic_dataset(CT_SWEEP_DATASET, cfg.trunk.vocab_size,
                           cfg.doc_maxlen - 2, cfg.query_maxlen - 2)
    shutil.rmtree(CT_DIR, ignore_errors=True)
    tcfg = TrainConfig(total_steps=CT_STEPS, checkpoint_every=CT_RESTART,
                       checkpoint_dir=CT_DIR, max_retries=0, log_every=1,
                       lr=CT_LR, warmup=CT_WARMUP)
    stamps, losses, accs = [], {}, {}

    def feed(start):
        for b in batches[start:]:
            stamps.append(time.perf_counter())   # each step ends synced
            yield b

    def hook(step, loss, metrics):
        losses[step] = loss
        accs[step] = float(metrics["acc"])
        if step % CT_LOG == 0:
            print(f"colbert_train step {step}: loss {loss:.4f}, in-batch "
                  f"acc {accs[step]:.4f} [{card}]")

    def loss_fn(m, b):
        return rt.colbert_loss(m, b["q"], b["d"])

    def drive():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(loss_fn, model, tcfg, device=dev)
        trainer.run(feed(0), hooks=hook)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        trained, sweep_s = _sweep(rt, torch, dev, model, ds)
        # readings: the step-0 weights, then the same run at a lower lr
        low = rt.init_colbert(cfg, seed=SEED, device=dev)
        untrained, _ = _sweep(rt, torch, dev, low, ds)
        cos = {"step 0": _mean_token_cos(torch, low, ds)}
        low_hist = Trainer(loss_fn, low, dataclasses.replace(
            tcfg, lr=CT_READING_LR, checkpoint_dir=None,
            log_every=CT_STEPS), device=dev).run(iter(batches))["history"]
        low_rep, _ = _sweep(rt, torch, dev, low, ds)
        cos[f"lr {CT_READING_LR}"] = _mean_token_cos(torch, low, ds)
        cos[f"lr {CT_LR}"] = _mean_token_cos(torch, model, ds)
        return (train_s, peak, trained, sweep_s, untrained, low_rep,
                low_hist[-1]["loss"], cos)

    (train_s, peak, trained, sweep_s, untrained, low_rep, low_loss,
     cos) = run_path("colbert_train", torch, drive)
    if PATH_LAUNCHES["colbert_train"]["flash_attention"]:
        raise AssertionError("colbert_train launched flash_attention")
    steps_ms = np.diff(stamps[:CT_STEPS]) * 1e3
    step_ms = float(np.median(steps_ms[CT_WARM:]))
    w = CT_LOSS_WINDOW
    first = float(np.mean([losses[s] for s in range(1, w + 1)]))
    last = float(np.mean([losses[s] for s in range(CT_STEPS - w + 1,
                                                   CT_STEPS + 1)]))
    print(f"colbert_train: {CT_STEPS} steps in {train_s:.3f}s (3 "
          f"checkpoints included); median step {step_ms:.3f} ms after "
          f"{CT_WARM} warm steps ({CT_BATCH / step_ms * 1e3:.1f} pairs/s); "
          f"peak device memory {peak} bytes; mean loss of steps 1-{w} "
          f"{first:.4f}, of steps {CT_STEPS - w + 1}-{CT_STEPS} {last:.4f}; "
          f"in-batch acc at {CT_STEPS} {accs[CT_STEPS]:.4f} [{card}]")
    if not last < first:
        raise AssertionError("colbert_train: the loss did not fall")
    after = [p.detach().clone() for p in model.parameters()]

    # a crash after step 100: the final checkpoint gone, a new process
    shutil.rmtree(os.path.join(CT_DIR, f"step_{CT_STEPS}"))
    restarted = rt.init_colbert(cfg, seed=SEED + 1, device=dev)
    t2 = Trainer(loss_fn, restarted, tcfg, device=dev)
    if t2.maybe_restore() != CT_RESTART:
        raise AssertionError(f"colbert_train: restored step {t2.step}, not "
                             f"{CT_RESTART}")
    stamps.clear()
    t2.run(feed(CT_RESTART))
    torch.cuda.synchronize()
    equal, diff = _params_equal(torch, after, list(restarted.parameters()))
    print(f"colbert_train: restarted at step {CT_RESTART} and run to "
          f"{CT_STEPS}: parameters bitwise equal to the uninterrupted "
          f"run's {equal} (max abs difference {diff:.3g}, limit "
          f"{CT_RESTART_ATOL})")
    if diff > CT_RESTART_ATOL:
        raise AssertionError("colbert_train: the restarted run diverged")
    del restarted, t2, after
    shutil.rmtree(CT_DIR, ignore_errors=True)

    print(f"colbert_train: mean cosine of two tokens of one doc: "
          + ", ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + f"; the lr {CT_READING_LR} run's loss at step {CT_STEPS} "
            f"{low_loss:.4f} (a reading) [{card}]")
    for rep, what in ((trained, f"trained {CT_STEPS} steps at lr {CT_LR}"),
                      (untrained, "step 0 (a reading)"),
                      (low_rep, f"trained {CT_STEPS} steps at lr "
                                f"{CT_READING_LR} (a reading)")):
        for c in rep.cells:
            if c.factor == 1 and not (
                    c.shared_baseline and c.relative["ndcg@10"] == 100.0):
                raise AssertionError("colbert_train: a factor-1 cell is not "
                                     "exactly 100.0")
        base = next(iter(rep.baselines.values())).metrics["ndcg@10"]
        print(f"colbert_train sweep, {what}: {CT_SWEEP_DATASET} "
              f"({ds.n_docs} docs, {ds.n_queries} queries) plaid 2-bit "
              f"ndcg@10 {base:.4f}; Ward relative ndcg@10 "
              + ", ".join(f"f={c.factor} {c.relative['ndcg@10']:.2f}"
                          for c in rep.cells) + f" [{card}]")
    print(trained.markdown_table("ndcg@10", "plaid", 2))
    _sweep_plain(rt, torch, dev, model, ds, trained)
    opt = rt.make_optimizer("adamw", CT_LR)
    state = opt.init(model)
    b = batches[-1]
    prof = _profile_step(torch, "colbert_train", lambda: rt.colbert_train_step(
        model, state, b["q"], b["d"], opt))
    return dict(step_ms=step_ms, pairs_s=CT_BATCH / step_ms * 1e3,
                peak_bytes=peak, loss_first20=first, loss_last20=last,
                acc_final=accs[CT_STEPS], restart_max_abs=diff,
                sweep_s=sweep_s,
                relative_trained={c.factor: c.relative["ndcg@10"]
                                  for c in trained.cells},
                relative_step0={c.factor: c.relative["ndcg@10"]
                                for c in untrained.cells},
                relative_low_lr={c.factor: c.relative["ndcg@10"]
                                 for c in low_rep.cells},
                mean_token_cos=cos, profile=prof)


def _rel_errors(torch, got, want):
    """Largest relative (Frobenius) difference over paired gradient lists
    and its parameter index."""
    worst, at = 0.0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        r = float((a - b).norm() / b.norm().clamp(min=1e-30))
        if r > worst:
            worst, at = r, i
    return worst, at


def lm_train_path(rt, torch, dev, card):
    """Qwen3-0.6B training at full width (random weights from seed 0,
    bf16 compute, f32 AdamW, remat): the driver (``_driver_run``) for 4
    steps of 8 x 2,048 tokens in 2 microbatches, checkpointed, then
    again to 6 steps, which must resume at 4 (both runs kept in
    ``LMT_RUNS`` for train_mesh); ``make_lm_train_step`` 4 times on one
    fixed batch (the loss must fall); every parameter's gradient finite;
    remat on against off at 2 x 2,048; 2 microbatches of 4 against one
    batch of 8; ``use_flash_kernel`` refused."""
    from repro_torch.launch.steps import lm_grads
    from repro_torch.train.params import leaves
    cfg = rt.get_config(LM_ARCH)
    if not cfg.remat or cfg.use_flash_kernel or cfg.optimizer != "adamw":
        raise AssertionError(f"{LM_ARCH}: expected remat, adamw, no flash")
    shutil.rmtree(LMT_DIR, ignore_errors=True)
    rng = np.random.default_rng(SEED + 2)
    toks = rng.integers(0, cfg.vocab_size, (LMT_BATCH, LMT_SEQ + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32,
                                       device=dev),
             "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32,
                                       device=dev)}

    def drive():
        run_a = _driver_run(torch, LMT_DIR, LMT_STEPS, None, "lm_train",
                            profile=True)
        if f"finished at step {LMT_STEPS}" not in run_a["text"]:
            raise AssertionError("lm_train: run A did not finish")
        resume = _driver_run(torch, LMT_DIR, LMT_RESUME, None, "lm_train",
                             final=True)
        if (f"resumed from step {LMT_STEPS}" not in resume["text"]
                or f"finished at step {LMT_RESUME}" not in resume["text"]):
            raise AssertionError("lm_train: run A did not resume")
        LMT_RUNS.update(a=run_a, resume=resume)
        a_s, r_s = run_a["seconds"], resume["seconds"]
        model = rt.init_transformer(cfg, seed=SEED, device=dev)
        step, opt = rt.make_lm_train_step(cfg, device=dev)
        state = opt.init(model)
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        for _ in range(LMT_B_STEPS):
            t0 = time.perf_counter()
            state, out = step(model, state, batch)
            losses.append(float(out["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return model, a_s, r_s, losses, secs, torch.cuda.max_memory_allocated()

    model, a_s, r_s, losses, secs, peak = run_path("lm_train", torch, drive)
    if any(PATH_LAUNCHES["lm_train"].values()):
        raise AssertionError("lm_train launched a kernel")
    n_tok = LMT_BATCH * LMT_SEQ
    step_s = float(np.median(secs[1:]))
    print(f"lm_train: launch.train run A ({LMT_STEPS} steps, checkpoint "
          f"included) {a_s:.3f}s, resumed to {LMT_RESUME} in {r_s:.3f}s; "
          f"make_lm_train_step on one batch of {LMT_BATCH} x {LMT_SEQ}: "
          f"losses {[round(x, 4) for x in losses]}, step s {secs} (median "
          f"after the first {step_s:.4f} s, {n_tok / step_s:.1f} tokens/s); "
          f"peak device memory {peak} bytes [{card}]")
    if not losses[-1] < losses[0]:
        raise AssertionError("lm_train: the loss did not fall")
    step, opt = rt.make_lm_train_step(cfg, device=dev)
    state = opt.init(model)
    prof = _profile_step(torch, "lm_train", lambda: step(model, state, batch))
    del state
    from repro_torch.models.transformer import lm_loss
    loss, _ = lm_loss(model, batch["tokens"], batch["labels"], cfg)
    _grads_all_finite("lm_train", torch, model, loss)
    del loss
    gc.collect()
    torch.cuda.empty_cache()

    # remat on against off, at batch 2 (no remat keeps every layer's scores)
    small = {k: v[:LMT_REMAT_BATCH] for k, v in batch.items()}
    res = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        loss, g = lm_grads(model, small["tokens"], small["labels"], c)
        res[remat] = (float(loss), leaves(g), torch.cuda.max_memory_allocated())
        del g
    equal, diff = _params_equal(torch, res[True][1], res[False][1])
    rel, _ = _rel_errors(torch, res[True][1], res[False][1])
    print(f"lm_train remat at {LMT_REMAT_BATCH} x {LMT_SEQ}: loss on "
          f"{res[True][0]:.6f}, off {res[False][0]:.6f}; gradients bitwise "
          f"equal {equal}, max abs difference {diff:.3g}, largest relative "
          f"(Frobenius) {rel:.3g} (limit {LMT_REMAT_REL}); peak device memory "
          f"on {res[True][2]}, off {res[False][2]} bytes [{card}]")
    if rel > LMT_REMAT_REL or res[True][0] != res[False][0]:
        raise AssertionError("lm_train: remat changes the gradients")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # 2 microbatches of 4 against one batch of 8 (f32 accumulator)
    one, g1 = lm_grads(model, batch["tokens"], batch["labels"], cfg)
    g1 = leaves(g1)
    two, g2 = lm_grads(model, batch["tokens"], batch["labels"],
                       dataclasses.replace(cfg, train_microbatches=2))
    g2 = leaves(g2)
    rel, at = _rel_errors(torch, g2, g1)
    name = [n for n, _ in model.named_parameters()][at]
    print(f"lm_train microbatches: loss of one batch of {LMT_BATCH} "
          f"{float(one):.6f}, of 2 x {LMT_BATCH // 2} {float(two):.6f} "
          f"(limit {LMT_MICRO_LOSS}); gradients' largest relative "
          f"(Frobenius) difference {rel:.3g} at {name} (limit "
          f"{LMT_MICRO_REL}) [{card}]")
    if abs(float(one) - float(two)) > LMT_MICRO_LOSS or rel > LMT_MICRO_REL:
        raise AssertionError("lm_train: microbatches disagree")
    del g1, g2
    try:
        rt.make_lm_train_step(dataclasses.replace(cfg, use_flash_kernel=True),
                              device=dev)
    except ValueError as e:
        print(f"lm_train: make_lm_train_step refuses use_flash_kernel: {e}")
    else:
        raise AssertionError("lm_train: use_flash_kernel was not refused")
    del model
    shutil.rmtree(LMT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_s=step_s, tokens_s=n_tok / step_s, peak_bytes=peak,
                losses=losses, run_a_s=a_s, resume_s=r_s,
                driver_step_s=LMT_RUNS["a"]["step_s"],
                driver_peak_bytes=LMT_RUNS["a"]["peak"],
                remat_max_abs=diff, micro_rel=rel, profile=prof)


def _driver_run(torch, ckpt_dir, steps, mesh, what, final=False,
                profile=False):
    """``launch.train.run`` of Qwen3-0.6B (``LMT_*``; every step's loss
    and end time recorded from the trainer's ``_train_step``) to
    ``steps``, over ``mesh`` or on one device, its output
    printed under ``what`` -> its text, seconds, losses, step seconds
    (the median after the first), peak device memory and, with
    ``final``, the final parameters on the host (path -> array); with
    ``profile``, then one more step of its trainer on a random batch
    under ``torch.profiler`` (``_profile_step``, device activities
    only). The seconds of the
    checkpoint's phases print beside: the trainer's ``save`` (every
    leaf gathered and copied to the host), the writer's files (on its
    thread) and ``restore`` (the files read back)."""
    import io
    from repro_torch.launch import train as launch_train
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.params import to_tree, tree_paths
    from repro_torch.train.trainer import Trainer
    spent, stepped = {}, []

    def each_step(orig):
        def wrapper(*a, **k):
            loss, metrics = orig(*a, **k)
            stepped.append((float(loss), time.perf_counter()))
            return loss, metrics
        return orig, wrapper

    def timed(cls, name):
        orig = getattr(cls, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        return orig, wrapper

    patched = [(cls, name) + timed(cls, name) for cls, name in (
        (Trainer, "save"), (CheckpointManager, "_write"),
        (CheckpointManager, "restore"))]
    patched.append((Trainer, "_train_step") + each_step(Trainer._train_step))
    args = launch_train.parse_args([
        "--arch", LM_ARCH, "--batch", str(LMT_BATCH), "--seq",
        str(LMT_SEQ), "--microbatches", str(LMT_MICRO), "--checkpoint-dir",
        ckpt_dir, "--max-retries", "0", "--steps", str(steps)])
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for cls, name, _, wrapper in patched:
        setattr(cls, name, wrapper)
    try:
        with contextlib.redirect_stdout(out):
            trainer, res = launch_train.run(args, mesh)
    finally:
        for cls, name, orig, _ in patched:
            setattr(cls, name, orig)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    text = out.getvalue()
    print("\n".join(f"{what} driver: {line}"
                    for line in text.strip().splitlines()))
    print(f"{what} driver: {seconds:.3f} s; checkpoint gather and host "
          f"copies {spent.get('save', 0.0):.3f} s, files written "
          f"{spent.get('_write', 0.0):.3f} s, read "
          f"{spent.get('restore', 0.0):.3f} s")
    ends = [t for _, t in stepped]
    steps_s = [b - a for a, b in zip(ends[:-1], ends[1:])]
    run = dict(text=text, seconds=seconds, peak=peak, checkpoint_s=spent,
               losses=[x for x, _ in stepped],
               step_s=float(np.median(steps_s or [ends[0] - t0])))
    if final:
        run["final"] = dict(tree_paths(to_tree(trainer.params)))
    if profile:
        toks = np.random.default_rng(SEED + 3).integers(
            0, trainer.model.cfg.vocab_size, (LMT_BATCH, LMT_SEQ + 1))
        batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
                 "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}
        if mesh is None:
            batch = {k: v.to(trainer.device) for k, v in batch.items()}
        run["profile"] = _profile_step(
            torch, what, lambda: trainer._train_step(batch), host_ops=False)
    del trainer, res
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _tree_agree(torch, got, want):
    """(bit for bit equal, the largest relative (Frobenius) difference
    and its path) of two host trees (path -> array)."""
    worst, at, equal = 0.0, None, sorted(got) == sorted(want)
    for path, w in want.items():
        g = got.get(path)
        if g is None or g.shape != w.shape:
            return False, float("inf"), path
        if not np.array_equal(g, w):
            equal = False
            rel, _ = _rel_errors(torch, [torch.from_numpy(g)],
                                 [torch.from_numpy(w)])
            if rel >= worst:
                worst, at = rel, path
    return equal, worst, at


def train_mesh_path(rt, torch, dev, card):
    """lm_train's driver (``launch.train.run``) over the host mesh of one
    rank: the default group from an in-process store (NCCL on the card),
    the reference's rules, the parameters and AdamW's moments laid out
    as DTensors and each microbatch laid out over ``data``. 4 steps and
    a checkpoint, then resumed to 6: the losses and final parameters
    against lm_train's (``LMT_RUNS``), bit for bit, else within
    ``TMESH_REL`` relative with the largest difference printed. Then the
    mesh's step-4 checkpoint (hard links into another directory) is
    restored by the driver without a mesh: its 2 steps and final
    parameters against lm_train's resume the same way."""
    from repro_torch.launch.mesh import make_host_mesh, process_group
    t_path = time.perf_counter()
    fails = _checks()
    want_a, want_r = LMT_RUNS["a"], LMT_RUNS["resume"]
    cross_dir = TMESH_DIR + "_cross"
    for d in (TMESH_DIR, cross_dir):
        shutil.rmtree(d, ignore_errors=True)

    phases = {}

    def lap(name, t):
        phases[name] = time.perf_counter() - t
        return time.perf_counter()

    def drive():
        t = time.perf_counter()
        with process_group(dev):
            mesh = make_host_mesh(dev)
            t = lap("group", t)
            run_a = _driver_run(torch, TMESH_DIR, LMT_STEPS, mesh,
                                "train_mesh", profile=True)
            t = lap("run A and its profiled step", t)
            resume = _driver_run(torch, TMESH_DIR, LMT_RESUME, mesh,
                                 "train_mesh", final=True)
            t = lap("resume", t)
        step = f"step_{LMT_STEPS}"
        files = [os.path.join(TMESH_DIR, step, f)
                 for f in os.listdir(os.path.join(TMESH_DIR, step))]
        print(f"train_mesh: the step-{LMT_STEPS} checkpoint holds "
              f"{sum(map(os.path.getsize, files))} bytes in {len(files)} "
              f"files")
        os.makedirs(cross_dir)
        shutil.copytree(os.path.join(TMESH_DIR, step),
                        os.path.join(cross_dir, step), copy_function=os.link)
        with open(os.path.join(cross_dir, "latest"), "w") as f:
            f.write(str(LMT_STEPS))
        cross = _driver_run(torch, cross_dir, LMT_RESUME, None,
                            "train_mesh no mesh", final=True)
        lap("cross", t)
        return run_a, resume, cross

    run_a, resume, cross = run_path("train_mesh", torch, drive)
    t_checks = time.perf_counter()
    _check(fails, f"mesh {{'data': 1}} over 1 ranks ({dev.type})"
           in run_a["text"],
           "train_mesh: the host mesh of one rank")
    _check(fails, f"resumed from step {LMT_STEPS}" in resume["text"]
           and f"resumed from step {LMT_STEPS}" in cross["text"],
           "train_mesh: both resumes start at step 4")
    for what, got, want in (("run A", run_a, want_a),
                            ("resumed", resume, want_r),
                            ("no mesh from the mesh's checkpoint", cross,
                             want_r)):
        g, w = np.array(got["losses"]), np.array(want["losses"])
        rel = float(np.max(np.abs(g - w) / np.abs(w))) if len(g) == len(
            w) else float("inf")
        print(f"train_mesh {what}: losses {got['losses']} against "
              f"lm_train's {want['losses']}: bit for bit "
              f"{got['losses'] == want['losses']}, largest relative {rel:.3g}")
        _check(fails, len(g) == len(w) and rel <= TMESH_REL,
               f"train_mesh {what}: losses within {TMESH_REL}")
        if "final" in got:
            equal, worst, at = _tree_agree(torch, got["final"],
                                           want["final"])
            print(f"train_mesh {what}: final parameters bit for bit "
                  f"{equal}; largest relative (Frobenius) {worst:.3g} at "
                  f"{at}")
            _check(fails, worst <= TMESH_REL,
                   f"train_mesh {what}: final parameters within {TMESH_REL}")
    n_tok = LMT_BATCH * LMT_SEQ
    print(f"train_mesh: driver step (median after the first) on the mesh "
          f"{run_a['step_s']:.4f} s ({n_tok / run_a['step_s']:.1f} tokens/s),"
          f" peak {run_a['peak']} bytes; without a mesh (lm_train's run A) "
          f"{want_a['step_s']:.4f} s ({n_tok / want_a['step_s']:.1f} "
          f"tokens/s), peak {want_a['peak']} bytes; runs "
          f"{run_a['seconds']:.3f}, {resume['seconds']:.3f}, "
          f"{cross['seconds']:.3f} s; path "
          f"{time.perf_counter() - t_path:.3f} s [{card}]")
    t = lap("checks", t_checks)
    for d in (TMESH_DIR, cross_dir):
        shutil.rmtree(d, ignore_errors=True)
    lap("files removed", t)
    print("train_mesh phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    LMT_RUNS.clear()
    _raise_failed("train_mesh", fails)
    return dict(step_s=run_a["step_s"], tokens_s=n_tok / run_a["step_s"],
                peak_bytes=run_a["peak"], plain_step_s=want_a["step_s"],
                plain_peak_bytes=want_a["peak"], losses=run_a["losses"] +
                resume["losses"], profile=run_a["profile"],
                plain_profile=want_a["profile"], phases_s=phases,
                path_s=time.perf_counter() - t_path)


def _cells(rt, name):
    """The port's shape cells (``configs/base.py`` ``name``) by name."""
    import repro_torch.configs.base as base
    return {c.name: c for c in getattr(base, name)}


def _checks():
    """A list that collects failed checks: a path prints every reading
    first and raises at its end (``_raise_failed``)."""
    return []


def _check(fails, ok, what):
    print(f"  check {'ok' if ok else 'FAILED'}: {what}")
    if not ok:
        fails.append(what)


def _raise_failed(name, fails):
    if fails:
        raise AssertionError(f"{name}: failed checks: {fails}")


@contextlib.contextmanager
def _moe_routes(replay=None):
    """Keeps every MoE layer call's router ids and capacity keep mask
    (in call order) while the model runs. With ``replay`` (such a list)
    each call takes the replayed call's ids in place of its own top-k,
    the weights its own probabilities there, renormalised: the routes
    pinned to another run's."""
    import torch
    import repro_torch.models.moe as moe
    router, dispatch = moe._router, moe.dispatch
    routes = []

    def routed(p, x2d, cfg):
        weights, ids, aux = router(p, x2d, cfg)
        if replay is not None:
            ids = replay[len(routes)]["ids"]
            probs = torch.softmax(x2d.float() @ p.router.w.float(), dim=-1)
            weights = probs.gather(1, ids)
            weights = weights / weights.sum(dim=-1, keepdim=True)
        routes.append({"ids": ids})
        return weights, ids, aux

    def dispatched(ids, n_experts, capacity):
        keep, slot = dispatch(ids, n_experts, capacity)
        routes[-1]["keep"] = keep
        return keep, slot

    moe._router, moe.dispatch = routed, dispatched
    try:
        yield routes
    finally:
        moe._router, moe.dispatch = router, dispatch


def _flash_at(torch, q, k, v, what="moe"):
    """``flash_attention`` timed on one layer's own q, k, v beside its
    plain version and ``scaled_dot_product_attention`` -> readings."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    B, H, S, dh = q.shape
    pairs = B * H * S * (S + 1) // 2
    flop = 4 * dh * pairs
    with torch.no_grad():
        ms = _time_ms(lambda: flash_attention(q, k, v, causal=True), reps=20)
        plain_ms = _time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                    impl="ref"))
        rep = H // k.shape[1]
        kl = k.repeat_interleave(rep, dim=1) if rep > 1 else k
        vl = v.repeat_interleave(rep, dim=1) if rep > 1 else v
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, kl, vl, is_causal=True), reps=20)
    bound, by = _bound_ms(_nbytes(q, k, v) + q.numel() * q.element_size(),
                          flop, _hw().PEAK_FLOPS_BF16)
    print(f"flash_attention at the {what} shape (q {tuple(q.shape)}, k/v "
          f"{tuple(k.shape)}, bf16, causal): {ms:.4f} ms "
          f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by})")
    return dict(shape=[list(q.shape), list(k.shape)], ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by=by)


def _moe_serve(rt, torch, cfg, model, card, fails, name="moe",
               batch=MOE_BATCH, prompt=MOE_PROMPT, n_decode=MOE_DECODE):
    """A MoE trunk (path ``name``: Moonshot at MOE_LAYERS layers, Kimi K2
    at KIMI_LAYERS): prefill through the kernel path (counted), again
    (timed, layers' own kernel calls kept), then the plain path; route
    flips, drop shares and the agreement."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels import launch_counts
    L = cfg.n_layers
    tokens = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    with _moe_routes() as k_routes:
        logits, toks, cache, prefill_s, decode_s = run_path(
            name, torch, lambda: _serve(rt, torch, cfg, model, tokens,
                                        n_decode))
    peak = torch.cuda.max_memory_allocated()
    n = PATH_LAUNCHES[name]["flash_attention"]
    n_tok = batch * prompt
    print(f"{name}: flash_attention launches {n} (one a layer, none in the "
          f"{n_decode} decode steps); first pass prefill {prefill_s:.4f}s "
          f"({n_tok / prefill_s:.1f} tokens/s), decode "
          f"{decode_s / n_decode * 1e3:.3f} ms a step (batch {batch}); "
          f"peak device memory {peak} bytes [{card}]")
    _check(fails, n == L, f"{name}: {n} flash_attention launches == {L}")
    _check(fails, all(tuple(x.shape) == (batch, cfg.vocab_size)
                      and bool(torch.isfinite(x).all()) for x in logits),
           f"{name}: logits finite, [B, V]")
    captured = {}
    with _flash_replaced(_capturing((0, L - 1), captured)):
        _, _, _, prefill_s, decode_s = _serve(rt, torch, cfg, model, tokens,
                                              n_decode)
    print(f"{name}: steady prefill {prefill_s:.4f}s "
          f"({n_tok / prefill_s:.1f} tokens/s), decode "
          f"{decode_s / n_decode * 1e3:.3f} ms a step")
    try:
        _check_captured(name, torch, captured)
    except AssertionError as e:
        fails.append(str(e))
    flash = _flash_at(torch, *captured[0][:3], what=name)
    del captured
    plain = dataclasses.replace(cfg, use_flash_kernel=False)
    before = launch_counts()["flash_attention"]
    with _moe_routes() as p_routes:
        p_logits, p_toks, p_cache, p_prefill_s, _ = _serve(
            rt, torch, plain, model, tokens, n_decode)
    flips = [float((a["ids"] != b["ids"]).float().mean())
             for a, b in zip(k_routes[:L], p_routes[:L])]
    drops = [1.0 - float(r["keep"].float().mean()) for r in k_routes[:L]]
    print(f"{name}: prefill route flips, kernel vs plain path, share of "
          f"(token, slot) assignments per layer: "
          f"{[round(f, 6) for f in flips]}; dropped at the default capacity "
          f"({moe.capacity_for(n_tok, cfg)} an expert) per layer: "
          f"{[round(d, 6) for d in drops]}")
    l_err, l_rel = _errors(logits[0], p_logits[0])
    first, worst = _cache_errors(cache, p_cache, prompt)
    print(f"{name}, routes free: last-token logits max abs err {l_err:.4g}, "
          f"relative {l_rel:.4g}; cache layers 1.. largest relative "
          f"{worst:.4g} (readings: a flipped assignment changes a token's "
          f"expert output outright)")
    del p_logits, p_toks, p_cache
    # the plain path with the kernel path's routes: attention is all that
    # differs, so the lm path's limits hold
    with _moe_routes(replay=k_routes):
        p_logits, p_toks, p_cache, _, _ = _serve(rt, torch, plain, model,
                                                 tokens, n_decode)
    _check(fails, launch_counts()["flash_attention"] == before,
           f"{name}: the plain path launched no flash_attention")
    p_err, p_rel = _errors(logits[0], p_logits[0])
    first, p_worst = _cache_errors(cache, p_cache, prompt)
    print(f"{name}, routes pinned to the kernel path's: last-token logits max "
          f"abs err {p_err:.4g} (atol {LM_LOGITS_ATOL}), relative "
          f"{p_rel:.4g} (limit {LM_REL}); cache layer 0 max abs {first:.4g}, "
          f"layers 1.. largest relative {p_worst:.4g} (limit {LM_REL})")
    _check(fails, p_err <= LM_LOGITS_ATOL and p_rel <= LM_REL,
           f"{name} (routes pinned): last-token logits within the lm "
           f"limits")
    _check(fails, p_worst <= LM_REL,
           f"{name} (routes pinned): each layer's cache within {LM_REL}")
    try:
        _greedy_agree(logits, toks, p_logits, p_toks)
    except AssertionError as e:
        fails.append(f"{name} greedy (routes pinned): {e}")
    del cache, p_cache
    prefill = rt.make_lm_prefill_step(cfg)
    prof = _profile_step(torch, f"{name} prefill",
                         lambda: prefill(model, {"tokens": tokens}))
    return dict(prefill_s=prefill_s, prefill_tokens_s=n_tok / prefill_s,
                decode_ms=decode_s / n_decode * 1e3,
                plain_prefill_s=p_prefill_s, peak_bytes=peak,
                route_flips=flips, drop_share=drops, free_logits_max_abs=l_err,
                free_logits_rel=l_rel, free_cache_rel=worst,
                pinned_logits_max_abs=p_err, pinned_logits_rel=p_rel,
                pinned_cache_rel=p_worst, flash=flash, profile=prof)


def _moe_layer(torch, dev, moe, cfg, layer, what, fails, chunk=None):
    """One MoE layer on MOE_LAYER_TOKENS random tokens: capacity at the
    smallest drop-free capacity against the dense oracle (in token chunks
    of ``chunk``), the default capacity's drop share and time."""
    T, d, E = MOE_LAYER_TOKENS, cfg.d_model, cfg.n_experts
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn((1, T, d), generator=g, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        _, ids, _ = moe._router(layer, x[0], cfg)
        roomy = int(torch.bincount(ids.reshape(-1), minlength=E).max())
        C = moe.capacity_for(T, cfg)
        keep, _ = moe.dispatch(ids, E, C)
        drop = 1.0 - float(keep.float().mean())
        y_cap, _ = moe.moe_capacity(layer, x, cfg, capacity=roomy)
        step = chunk or T
        y_dense = torch.cat([moe.moe_dense(layer, x[:, i:i + step], cfg)[0]
                             for i in range(0, T, step)], dim=1)
        err, rel = _errors(y_cap, y_dense)
        del y_cap, y_dense
        ms = _time_ms(lambda: moe.moe_capacity(layer, x, cfg))
        dense_ms = _time_ms(lambda: torch.cat(
            [moe.moe_dense(layer, x[:, i:i + step], cfg)[0]
             for i in range(0, T, step)], dim=1), reps=2)
    print(f"{what}: one MoE layer ({E} experts top {cfg.top_k}, d "
          f"{d}, moe_d_ff {cfg.moe_d_ff}) on {T} tokens: capacity at "
          f"{roomy} (the largest expert's load: nothing dropped) against "
          f"the dense oracle{f' in chunks of {chunk}' if chunk else ''}: "
          f"max abs {err:.4g}, relative {rel:.4g} (limit {MOE_LAYER_REL}); "
          f"the default capacity {C} drops {drop:.6f} of the assignments; "
          f"default capacity {ms:.4f} ms, dense oracle {dense_ms:.4f} ms")
    _check(fails, rel <= MOE_LAYER_REL,
           f"{what}: capacity (nothing dropped) = dense within "
           f"{MOE_LAYER_REL} relative")
    return dict(tokens=T, roomy_capacity=roomy, capacity=C, drop_share=drop,
                max_abs=err, rel=rel, capacity_ms=ms, dense_ms=dense_ms)


def _moe_train(rt, torch, dev, card, fails):
    """Moonshot at MOE_TRAIN_LAYERS layers: MOE_TRAIN_STEPS
    ``make_lm_train_step`` calls on one batch, twice from one seed."""
    from repro_torch.launch.steps import lm_grads
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.params import leaves
    cfg = dataclasses.replace(rt.get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    toks = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (MOE_TRAIN_BATCH, MOE_PROMPT + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32,
                                       device=dev),
             "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32,
                                       device=dev)}

    def run():
        model = rt.init_transformer(cfg, seed=SEED, device=dev)
        step, opt = rt.make_lm_train_step(cfg, device=dev)
        state = opt.init(model)
        losses, secs = [], []
        for _ in range(MOE_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, out = step(model, state, batch)
            losses.append(float(out["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        del state
        return model, losses, secs

    torch.cuda.reset_peak_memory_stats()
    a, losses, secs = run()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    b, losses_b, _ = run()
    equal, diff = _params_equal(torch, list(a.parameters()),
                                list(b.parameters()))
    del a
    n_tok = MOE_TRAIN_BATCH * MOE_PROMPT
    step_s = float(np.median(secs[1:]))
    n_par = sum(p.numel() for p in b.parameters())
    print(f"moe_train: {MOE_ARCH} at {MOE_TRAIN_LAYERS} of 48 layers "
          f"({n_par} parameters; remat {cfg.remat}, {cfg.optimizer}, "
          f"{cfg.train_microbatches} microbatches): {MOE_TRAIN_STEPS} steps "
          f"on one batch of {MOE_TRAIN_BATCH} x {MOE_PROMPT}: losses "
          f"{[round(x, 4) for x in losses]}, step s {secs} (median after the "
          f"first {step_s:.4f} s, {n_tok / step_s:.1f} tokens/s); peak device "
          f"memory {peak} bytes; a second run from the seed: losses "
          f"{[round(x, 4) for x in losses_b]}, parameters bitwise equal "
          f"{equal} (max abs difference {diff:.3g}) [{card}]")
    _check(fails, losses[-1] < losses[0], "moe_train: the loss falls")
    _check(fails, equal, "moe_train: two runs from one seed bitwise equal")
    with torch.no_grad():
        _, metrics = lm_loss(b, batch["tokens"], batch["labels"], cfg)
    aux = float(metrics["aux"])
    _, grads = lm_grads(b, batch["tokens"], batch["labels"], cfg)
    bad = [p for p, g in grads.items()
           if not all(bool(torch.isfinite(t).all()) and bool(t.any())
                      for t in leaves(g))]
    router = sum(float(t.abs().sum()) for t in leaves(
        grads["moe_layers/moe/router/w"]))
    print(f"moe_train: router aux {aux:.6g}; {len(grads)} gradient groups, "
          f"not finite or all zero: {bad}; the router's |grad| sum "
          f"{router:.4g}")
    _check(fails, aux > 0, "moe_train: aux > 0")
    _check(fails, not bad and router > 0,
           "moe_train: every gradient finite and not all zero")
    del b, grads
    return dict(step_s=step_s, tokens_s=n_tok / step_s, peak_bytes=peak,
                losses=losses, bitwise_equal=equal, aux=aux)


def moe_path(rt, torch, dev, card):
    """Moonshot serving at full width (8 of 48 layers) against the plain
    attention path, one Moonshot MoE layer against the dense oracle,
    Moonshot training (2 layers), then a Kimi K2 trunk at full width (1
    of 61 layers) served through ``flash_attention`` at dh 112 against
    the plain path, and its MoE layer against the dense oracle."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels import launch_counts
    fails = _checks()
    full = rt.get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS,
                              use_flash_kernel=True)
    if (cfg.d_head, cfg.n_experts, cfg.top_k, cfg.dtype) != (
            128, 64, 6, "bfloat16"):
        raise AssertionError(f"{MOE_ARCH}: unexpected config {cfg}")
    t0 = time.perf_counter()
    model = rt.init_transformer(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"moe setup: {MOE_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.d_head}, {cfg.n_experts} experts top "
          f"{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}), "
          f"{MOE_LAYERS} of {full.n_layers} layers: {n_par} parameters "
          f"({cfg.param_count()} by the config; the full depth "
          f"{full.param_count()}, {full.param_count() * 4} bytes in "
          f"{full.param_dtype}), random from seed {SEED}, in "
          f"{time.perf_counter() - t0:.3f}s")
    serve = _moe_serve(rt, torch, cfg, model, card, fails)
    counts = launch_counts()
    layer = _moe_layer(torch, dev, moe, cfg, model.moe_layers[0].moe,
                       "moe layer", fails)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train = _moe_train(rt, torch, dev, card, fails)
    gc.collect()
    torch.cuda.empty_cache()
    _check(fails, launch_counts() == counts,
           "moe: the layer check and training launch no kernel")
    kimi, kimi_layer = _kimi(rt, torch, dev, card, fails)
    _raise_failed("moe", fails)
    return dict(serve=serve, layer=layer, train=train, kimi=kimi,
                kimi_layer=kimi_layer)


def _kimi(rt, torch, dev, card, fails):
    """Kimi K2 at full width, KIMI_LAYERS of its 61 layers (no dense
    prefix: each layer is attention at dh 112 and a 16.9B-parameter MoE
    layer): served as Moonshot is (path kimi), then its MoE layer against
    the dense oracle."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels import launch_counts
    full = rt.get_config(KIMI_ARCH)
    cfg = dataclasses.replace(full, n_layers=KIMI_LAYERS,
                              use_flash_kernel=True)
    if (cfg.d_head, cfg.n_heads, cfg.n_kv_heads, cfg.n_experts, cfg.top_k,
            cfg.first_dense_layers, cfg.param_dtype) != (
            112, 64, 8, 384, 8, 0, "bfloat16"):
        raise AssertionError(f"{KIMI_ARCH}: unexpected config {cfg}")
    t0 = time.perf_counter()
    model = rt.init_transformer(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"kimi setup: {KIMI_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.d_head} over {cfg.n_kv_heads} kv "
          f"heads, {cfg.n_experts} experts top {cfg.top_k}, moe_d_ff "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype} "
          f"parameters), {KIMI_LAYERS} of {full.n_layers} layers: {n_par} "
          f"parameters ({n_par * 2} bytes; the full depth "
          f"{full.param_count()}), random from seed {SEED}, in "
          f"{time.perf_counter() - t0:.3f}s [{card}]")
    serve = _moe_serve(rt, torch, cfg, model, card, fails, name="kimi",
                       batch=KIMI_BATCH, prompt=KIMI_PROMPT,
                       n_decode=KIMI_DECODE)
    counts = launch_counts()
    layer = _moe_layer(torch, dev, moe, cfg, model.moe_layers[0].moe,
                       "kimi layer", fails, chunk=KIMI_CHUNK)
    _check(fails, launch_counts() == counts,
           "kimi: the layer check launches no kernel")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return serve, layer


# ---------------------------------------------------------------- gnn
def _lattice(n, rng):
    """Positions of n nodes: a cubic lattice of side ceil(n^(1/3)) at
    LATTICE_A spacing, filled in row-major order, each point jittered by
    up to LATTICE_JITTER: any two nodes at least 1 A apart, as atoms are
    (DimeNet's bases blow up near d = 0, in both packages) -> (positions
    [n, 3] f32, side)."""
    m = int(np.ceil(n ** (1 / 3) - 1e-9))
    idx = np.arange(n)
    grid = np.stack([idx // (m * m), (idx // m) % m, idx % m], 1)
    jitter = rng.uniform(-LATTICE_JITTER, LATTICE_JITTER, (n, 3))
    return (grid * LATTICE_A + jitter).astype(np.float32), m


def _local_edges(dst, n, m, reach, rng):
    """A source for each destination node: a lattice neighbour within
    ``reach`` cells on each axis (not itself) -> src."""
    coord = np.stack([dst // (m * m), (dst // m) % m, dst % m], 1)
    off = rng.integers(-reach, reach + 1, (len(dst), 3))
    off[(off == 0).all(1), 0] = 1
    c = np.clip(coord + off, 0, m - 1)
    src = np.minimum((c[:, 0] * m + c[:, 1]) * m + c[:, 2], n - 1)
    same = src == dst
    src[same] = (dst[same] + 1) % n
    return src


def _molecule_inputs(rt, rng, n_graphs, n_atoms, n_edges, cap):
    """``n_graphs`` molecules of ``n_atoms`` atoms on a jittered lattice
    (types < 10) with ``n_edges`` directed edges each (both directions
    of random pairs of lattice neighbours), graph targets normal."""
    lattices = [_lattice(n_atoms, rng) for _ in range(n_graphs)]
    m = lattices[0][1]
    dst = rng.integers(0, n_atoms, (n_graphs, n_edges // 2))
    src = _local_edges(dst.reshape(-1), n_atoms, m, 1, rng).reshape(
        dst.shape)
    base = (np.arange(n_graphs) * n_atoms)[:, None]
    ei = np.stack([np.concatenate([src + base, dst + base], 1).reshape(-1),
                   np.concatenate([dst + base, src + base], 1).reshape(-1)]
                  ).astype(np.int32)
    N, E = n_graphs * n_atoms, ei.shape[1]
    t_in, t_out, t_mask = rt.build_triplets(ei, N, cap)
    pos = np.concatenate([p for p, _ in lattices])
    return {"pos": pos, "edge_index": ei, "t_in": t_in, "t_out": t_out,
            "t_mask": t_mask, "node_mask": np.ones(N, bool),
            "edge_mask": np.ones(E, bool),
            "z": rng.integers(0, 10, N).astype(np.int32),
            "graph_ids": np.repeat(np.arange(n_graphs), n_atoms).astype(
                np.int32),
            "targets": rng.normal(size=(n_graphs, 1)).astype(np.float32)}


def _citation_inputs(rt, rng, n_nodes, n_edges, d_feat, n_cls, cap):
    """A citation-sized graph on a jittered lattice: ``n_edges`` directed
    edges (both directions of random pairs of lattice neighbours within
    2 cells), bag-of-words features at Cora's density (18 words of
    1,433)."""
    pos, m = _lattice(n_nodes, rng)
    b = rng.integers(0, n_nodes, n_edges // 2)
    a = _local_edges(b, n_nodes, m, 2, rng)
    ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])]).astype(
        np.int32)
    t_in, t_out, t_mask = rt.build_triplets(ei, n_nodes, cap)
    return {"pos": pos, "edge_index": ei, "t_in": t_in, "t_out": t_out,
            "t_mask": t_mask, "node_mask": np.ones(n_nodes, bool),
            "edge_mask": np.ones(ei.shape[1], bool),
            "feat": (rng.random((n_nodes, d_feat)) < 18 / 1433).astype(
                np.float32),
            "targets": rng.integers(0, n_cls, n_nodes).astype(np.int32)}


def _gnn_cpu_agree(rt, torch, model, cfg, batch, task, n_graphs, what,
                   fails):
    """The first batch through the port on the card and on the CPU, in
    f32 compute (TF32 off on the card), at the initial weights."""
    c32 = dataclasses.replace(cfg, dtype="float32")
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    cpu = rt.DimeNet(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    torch.set_num_threads(os.cpu_count() or 1)
    with torch.no_grad():
        card_out = rt.dimenet_forward(model, inputs, c32, task=task,
                                      n_graphs=n_graphs).cpu()
        t0 = time.perf_counter()
        cpu_out = rt.dimenet_forward(cpu, {k: (v.cpu() if torch.is_tensor(v)
                                               else v)
                                           for k, v in inputs.items()},
                                     c32, task=task, n_graphs=n_graphs)
        cpu_s = time.perf_counter() - t0
    err, rel = _errors(card_out, cpu_out)
    print(f"gnn {what}: the first batch on the card and on the CPU (f32 "
          f"compute, {cpu_s:.2f}s there): max abs {err:.4g}, relative "
          f"{rel:.4g} (limit {GNN_CPU_REL})")
    _check(fails, rel <= GNN_CPU_REL, f"gnn {what}: card = CPU within "
           f"{GNN_CPU_REL} relative")
    return rel


def _gnn_train(rt, torch, cfg, batches, task, n_graphs, what, card, fails,
               per_step=1, unit="graphs", profile=False):
    """``make_gnn_train_step`` over ``batches`` (a list, or a callable
    giving (batch, host seconds)) from seed-0 weights -> readings; with
    ``profile`` one more step on the last batch under the profiler."""
    model = rt.init_dimenet(cfg, seed=SEED)
    step, opt = rt.make_gnn_train_step(cfg, task, n_graphs=n_graphs)
    state = opt.init(model)
    losses, secs, host = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        if callable(batch):
            batch, host_s = batch()
            host.append(host_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(model, state, batch)
        losses.append(float(out["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(secs[1:] if len(secs) > 1 else secs))
    host_txt = (f"; host sampling + triplets s {[round(h, 4) for h in host]}"
                if host else "")
    print(f"gnn {what}: {len(secs)} steps, losses "
          f"{[round(x, 5) for x in losses]}; step s "
          f"{[round(s, 4) for s in secs]} (median after the first "
          f"{step_s * 1e3:.3f} ms, {per_step / step_s:.1f} {unit}/s)"
          f"{host_txt}; peak "
          f"device memory {peak} bytes [{card}]")
    _check(fails, all(np.isfinite(losses)), f"gnn {what}: losses finite")
    prof = (_profile_step(torch, f"gnn {what}", lambda: step(model, state,
                                                             batch))
            if profile else None)
    return model, dict(losses=losses, step_ms=step_s * 1e3,
                       per_s=per_step / step_s, peak_bytes=peak,
                       host_s=host or None, profile=prof)


def gnn_path(rt, torch, dev, card):
    """DimeNet at the published widths on three of the reference's
    GNN_SHAPES cells: molecule (graph task), full_graph_sm and
    minibatch_lg (node task, the latter through ``NeighborSampler``)."""
    fails = _checks()
    base = rt.get_config("dimenet")
    rng = np.random.default_rng(SEED + 8)
    cells = _cells(rt, "GNN_SHAPES")
    mol_c, sm_c, lg_c = (cells[n] for n in ("molecule", "full_graph_sm",
                                             "minibatch_lg"))
    n_graphs = mol_c.dim("batch")

    def drive():
        out = {}
        # molecule: 128 graphs of 30 atoms, 64 directed edges each
        cfg = dataclasses.replace(base, d_feat_in=0, n_targets=1)
        mol = _molecule_inputs(rt, rng, n_graphs, mol_c.dim("n_nodes"),
                               mol_c.dim("n_edges"), cfg.triplet_cap)
        first, o = _gnn_train(rt, torch, cfg, [mol] * GNN_STEPS["molecule"],
                              "graph", n_graphs, "molecule", card, fails,
                              n_graphs)
        again, _ = _gnn_train(rt, torch, cfg, [mol] * GNN_STEPS["molecule"],
                              "graph", n_graphs, "molecule (again)", card,
                              fails, n_graphs)
        equal, diff = _params_equal(torch, list(first.parameters()),
                                    list(again.parameters()))
        print(f"gnn molecule: two runs from one seed bitwise equal {equal} "
              f"(max abs difference {diff:.3g})")
        _check(fails, equal, "gnn molecule: two runs bitwise equal")
        w = np.mean(o["losses"][-5:]) < np.mean(o["losses"][:5])
        _check(fails, w, "gnn molecule: the loss falls (last 5 vs first 5)")
        o["bitwise_equal"] = equal
        o["cpu_rel"] = _gnn_cpu_agree(rt, torch, rt.init_dimenet(
            cfg, seed=SEED), cfg, mol, "graph", n_graphs, "molecule",
            fails)
        out["molecule"] = o
        del first, again
        # full_graph_sm: 2,708 nodes, 10,556 edges, 1,433 features, 7 classes
        n_sm = sm_c.dim("n_nodes")
        cfg = dataclasses.replace(base, d_feat_in=sm_c.dim("d_feat"),
                                  n_targets=GNN_CLASSES["full_graph_sm"])
        cit = _citation_inputs(rt, rng, n_sm, sm_c.dim("n_edges"),
                               cfg.d_feat_in, cfg.n_targets, cfg.triplet_cap)
        _, o = _gnn_train(rt, torch, cfg, [cit] * GNN_STEPS["full_graph_sm"],
                          "node", 1, "full_graph_sm", card, fails, n_sm,
                          "nodes")
        o["cpu_rel"] = _gnn_cpu_agree(rt, torch, rt.init_dimenet(
            cfg, seed=SEED), cfg, cit, "node", 1, "full_graph_sm", fails)
        out["full_graph_sm"] = o
        # minibatch_lg: 1,024 seeds, fanouts 15, 10 over a synthetic
        # Reddit-sized graph (232,965 nodes, in-degree 50)
        cfg = dataclasses.replace(base, d_feat_in=GNN_MINIBATCH_FEAT,
                                  n_targets=GNN_CLASSES["minibatch_lg"])
        N = lg_c.dim("n_nodes")
        seeds_n = lg_c.dim("batch_nodes")
        fanouts = (lg_c.dim("fanout0"), lg_c.dim("fanout1"))
        t0 = time.perf_counter()
        pos, m = _lattice(N, rng)
        dst = np.repeat(np.arange(N), MINIBATCH_DEGREE)
        ei = np.stack([_local_edges(dst, N, m, 2, rng), dst])
        sampler = rt.NeighborSampler(ei, N, fanouts, seed=SEED)
        del ei, dst
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        feat = torch.randn((N, cfg.d_feat_in), generator=g, device=dev)
        labels = torch.randint(0, cfg.n_targets, (N,), generator=g,
                               device=dev)
        print(f"gnn minibatch_lg setup: {N} nodes, {N * MINIBATCH_DEGREE} "
              f"edges, the sampler's CSR in {time.perf_counter() - t0:.3f}s; "
              f"budgets {sampler.node_budget(seeds_n)} nodes, "
              f"{sampler.edge_budget(seeds_n)} edges, "
              f"{sampler.edge_budget(seeds_n) * cfg.triplet_cap} triplets "
              f"(the cell's {lg_c.dim('n_edges')} edges cut to in-degree "
              f"{MINIBATCH_DEGREE}: the budgets do not depend on it)")

        def sample():
            t0 = time.perf_counter()
            seeds = rng.choice(N, seeds_n, replace=False)
            nodes, sub, nmask, emask = sampler.sample(seeds)
            t_in, t_out, t_mask = rt.build_triplets(sub, len(nodes),
                                                    cfg.triplet_cap)
            host_s = time.perf_counter() - t0
            idx = torch.as_tensor(nodes, device=dev)
            return {"pos": pos[nodes], "edge_index": sub, "t_in": t_in,
                    "t_out": t_out, "t_mask": t_mask, "node_mask": nmask,
                    "edge_mask": emask, "feat": feat[idx],
                    "targets": labels[idx]}, host_s

        firsts = []

        def first_sample():
            b, s = sample()
            firsts.append(b)
            return b, s

        _, o = _gnn_train(rt, torch, cfg, [first_sample] + [sample] * (
            GNN_STEPS["minibatch_lg"] - 1), "node", 1, "minibatch_lg", card,
            fails, seeds_n, "seeds", profile=True)
        o["cpu_rel"] = _gnn_cpu_agree(rt, torch, rt.init_dimenet(
            cfg, seed=SEED), cfg, firsts[0], "node", 1, "minibatch_lg",
            fails)
        out["minibatch_lg"] = o
        return out

    out = run_path("gnn", torch, drive)
    _check(fails, not any(PATH_LAUNCHES["gnn"].values()),
           "gnn: no kernel launched (DimeNet reaches none, in either "
           "package)")
    gc.collect()
    torch.cuda.empty_cache()
    _raise_failed("gnn", fails)
    return out


# ------------------------------------------------------------- recsys
def _recsys_batch(cfg, rng, n, label=True):
    b = {"sparse_ids": np.stack(
        [rng.integers(0, v, (n, cfg.multi_hot)) for v in cfg.vocab_sizes],
        axis=1).astype(np.int32)}
    if cfg.n_dense:
        b["dense"] = rng.normal(size=(n, cfg.n_dense)).astype(np.float32)
    if label:
        b["label"] = (rng.random(n) < 0.25).astype(np.float32)
    return b


def _recsys_model(rt, torch, dev, cfg, card, fails):
    """One recsys model at its config: train_batch (twice from the
    seed), serve_p99, serve_bulk, retrieval_cand, and one serve batch
    against the port on the CPU -> readings."""
    from repro_torch.core.maxsim import tie_aware_mismatches
    from repro_torch.models.layers import dt
    from repro_torch.models.recsys import embedding_bag
    rng = np.random.default_rng(SEED + 10)
    name = cfg.name
    shapes = _cells(rt, "RECSYS_SHAPES")
    n_train = shapes["train_batch"].dim("batch")
    n_p99 = shapes["serve_p99"].dim("batch")
    n_bulk = shapes["serve_bulk"].dim("batch")
    n_cand = shapes["retrieval_cand"].dim("n_candidates")
    train = _recsys_batch(cfg, rng, n_train)

    def run():
        model = rt.init_recsys(cfg, seed=SEED)
        step, opt = rt.make_recsys_train_step(cfg)
        state = opt.init(model)
        losses, secs = [], []
        for _ in range(RECSYS_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, out = step(model, state, train)
            losses.append(float(out["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        del state
        return model, losses, secs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, losses, secs = run()
    peak = torch.cuda.max_memory_allocated()
    first_s = time.perf_counter() - t0
    again, losses_b, _ = run()
    equal, diff = _params_equal(torch, list(model.parameters()),
                                list(again.parameters()))
    del again
    gc.collect()
    torch.cuda.empty_cache()
    step_s = float(np.median(secs[1:]))
    n_par = sum(p.numel() for p in model.parameters())
    print(f"recsys {name}: {n_par} parameters ({cfg.n_sparse} tables of "
          f"{max(cfg.vocab_sizes)} x {cfg.embed_dim}); train_batch "
          f"{n_train}: losses {[round(x, 5) for x in losses]}, step s "
          f"{[round(s, 4) for s in secs]} (median after the first "
          f"{step_s:.4f} s, {n_train / step_s:.1f} samples/s; init + 3 steps "
          f"{first_s:.3f}s); peak device memory {peak} bytes; again from the "
          f"seed: losses {[round(x, 5) for x in losses_b]}, parameters "
          f"bitwise equal {equal} (max abs difference {diff:.3g}) [{card}]")
    _check(fails, losses[-1] < losses[0], f"recsys {name}: the loss falls")
    _check(fails, equal, f"recsys {name}: two runs bitwise equal")
    step, opt = rt.make_recsys_train_step(cfg)
    state = opt.init(model)
    prof = _profile_step(torch, f"recsys {name} train step",
                         lambda: step(model, state, train))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    serve = rt.make_recsys_serve_step(cfg)
    p99 = _recsys_batch(cfg, rng, n_p99, label=False)
    times = []
    for _ in range(RECSYS_SERVE_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = serve(model, p99)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p99_ms = float(np.median(times[1:])) * 1e3
    cpu = rt.Recsys(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        cpu_logits = rt.recsys_forward(cpu, p99)
    del cpu
    err, rel = _errors(logits.cpu(), cpu_logits)
    _check(fails, bool(torch.isfinite(logits).all()) and tuple(
        logits.shape) == (n_p99,),
        f"recsys {name}: serve logits finite, [B]")
    _check(fails, err <= RECSYS_CPU_ATOL,
           f"recsys {name}: card = CPU within {RECSYS_CPU_ATOL}")
    bulk = _recsys_batch(cfg, rng, n_bulk, label=False)
    serve(model, bulk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(model, bulk)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    cand = torch.randn((n_cand, cfg.embed_dim),
                       generator=g, device=dev)
    one = _recsys_batch(cfg, rng, 1, label=False)
    retrieve = rt.make_recsys_retrieval_step(cfg, k=RECSYS_TOPK)
    scores, ids = retrieve(model, dict(one, candidates=cand))
    with torch.no_grad():
        cdt = dt(cfg.dtype)
        user = embedding_bag(model.tables, torch.as_tensor(
            one["sparse_ids"], device=dev), dtype=cdt).mean(dim=1)
        full = (user @ cand.to(cdt).T).float()
        s_all, i_all = torch.sort(full, dim=1, descending=True, stable=True)
    n_ties = int((s_all[0, 1:RECSYS_TOPK + 1] == s_all[0, :RECSYS_TOPK]
                  ).sum())
    bad = tie_aware_mismatches(
        i_all[:, :RECSYS_TOPK].cpu().numpy(),
        s_all[:, :RECSYS_TOPK].cpu().numpy(), ids.cpu().numpy(),
        scores.cpu().numpy(), 0.0)
    with torch.no_grad():
        ret_ms = _time_ms(lambda: retrieve(model, dict(one, candidates=cand)))
    print(f"recsys {name}: serve_p99 batch {n_p99}: "
          f"median of {RECSYS_SERVE_REPS} calls {p99_ms:.4f} ms (slowest "
          f"{max(times[1:]) * 1e3:.4f}); against the port on the CPU max abs "
          f"{err:.4g} (limit {RECSYS_CPU_ATOL}), relative {rel:.4g}; "
          f"serve_bulk {n_bulk} in {bulk_s:.4f}s "
          f"({n_bulk / bulk_s:.1f} samples/s); "
          f"retrieval_cand 1 x {n_cand} top "
          f"{RECSYS_TOPK}: {ret_ms:.4f} ms, ids against a full stable sort: "
          f"{bad} mismatches beyond exact ties ({n_ties} exact ties in the "
          f"top {RECSYS_TOPK}) [{card}]")
    _check(fails, bad == 0, f"recsys {name}: top-{RECSYS_TOPK} ids equal a "
           f"full sort's, tie-aware")
    del model, cand, full, s_all, i_all
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params=n_par, train_step_s=step_s,
                train_samples_s=n_train / step_s, losses=losses,
                bitwise_equal=equal, peak_bytes=peak, p99_batch_ms=p99_ms,
                cpu_max_abs=err, bulk_samples_s=n_bulk / bulk_s,
                retrieval_ms=ret_ms, profile=prof)


def recsys_path(rt, torch, dev, card):
    """The four recsys models at their configs (1M-row tables a field) on
    the reference's RECSYS_SHAPES, each freed before the next."""
    fails = _checks()
    out = run_path("recsys", torch, lambda: {
        arch: _recsys_model(rt, torch, dev, rt.get_config(arch), card, fails)
        for arch in RECSYS_ARCHS})
    _check(fails, not any(PATH_LAUNCHES["recsys"].values()),
           "recsys: no kernel launched (no recsys model reaches one, in "
           "either package)")
    _raise_failed("recsys", fails)
    return out


SHARDED_BATCH = 2                  # Qwen3-0.6B prefill on the one-rank mesh
SHARDED_PROMPT = 1024
SHARDED_SERVE = 512                # dlrm-rm2's serve_p99 batch
# one cell of each place stage 3 stopped before the models carried the
# reference's annotations, and dlrm-rm2 serve_p99; stage 3 at one layer
# over the fake (16, 16) group
SHARDED_STAGE3 = (
    ("qwen1.5-0.5b", "train_4k"),      # transformer.py:91, residual add
    ("qwen1.5-0.5b", "decode_32k"),    # transformer.py:99, decode's
    ("qwen2.5-14b", "long_500k"),      # attention.py:97, 8 kv heads / 16
    ("colbertv2", "search"),           # attention.py:97, 12 heads / 16
    ("qwen3-0.6b", "decode_32k"),      # attention.py:98, the kv view
    ("qwen2.5-14b", "prefill_32k"),    # attention.py:217, 40 heads, qseq
    ("dimenet", "molecule"),           # layers.py:67, DimeNet's products
    ("dlrm-rm2", "serve_p99"),         # embedding.py:48 on torch 2.11
)
ROOFLINE_ARCH = "dlrm-rm2"
ROOFLINE_REPS = 3                  # timed steps a cell, after a warm one
ROOFLINE_DRY = ("dimenet", "ogb_products")


def _report_shapes(index, probe_args, packed_args):
    """The main path's shapes as ``roofline/packed.py`` and
    ``roofline/probe.py`` take them, read from one search batch's two
    captured calls."""
    q, _, cen, codes = probe_args[:4]
    pq, _, words = packed_args[:3]
    plaid = index._plaid
    return dict(
        bits=plaid.codec.bits,
        packed=dict(nq=pq.shape[0], lq=pq.shape[1], s=words.shape[1],
                    ld=words.shape[2], dim=pq.shape[2],
                    k_centroids=packed_args[5].shape[0]),
        probe=dict(nq=q.shape[0], lq=q.shape[1], k_centroids=cen.shape[0],
                   nprobe=index.nprobe, lmax=plaid.device_ivf().list_cap,
                   c=codes.shape[1], ld=codes.shape[2], dim=q.shape[2]))


def _recsys_cell_inputs(rt, torch, dev, cfg, model, cell, rng):
    """The step and its arguments after the model for one recsys cell,
    built on the card at the shapes the dry run predicts."""
    shapes = _cells(rt, "RECSYS_SHAPES")
    n = shapes[cell].dim("batch")
    if cell == "train_batch":
        step, opt = rt.make_recsys_train_step(cfg)
        return step, [opt.init(model), {
            k: torch.as_tensor(v, device=dev)
            for k, v in _recsys_batch(cfg, rng, n).items()}]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in _recsys_batch(cfg, rng, n, label=False).items()}
    if cell == "retrieval_cand":
        g = torch.Generator(device=dev).manual_seed(SEED + 21)
        batch["candidates"] = torch.randn(
            (shapes[cell].dim("n_candidates"), cfg.embed_dim), generator=g,
            device=dev)
        return rt.make_recsys_retrieval_step(cfg), [batch]
    return rt.make_recsys_serve_step(cfg), [batch]


def _roofline_cell(rt, torch, dev, cfg, model, cell, rng, card, fails):
    """One dlrm-rm2 cell: the dry run on a one-rank (1, 1) view of the
    production axes against the same step on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline.analysis import RooflineTerms, nbytes
    pred = run_cell(ROOFLINE_ARCH, cell, mesh_shape=(1, 1), verbose=False)
    step, rest = _recsys_cell_inputs(rt, torch, dev, cfg, model, cell, rng)
    real = nbytes([list(model.parameters()), rest])
    with FlopCounterMode(display=False) as counter:
        step(model, *rest)
    torch.cuda.synchronize()
    flops = counter.get_total_flops()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(model, *rest)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    secs = []
    for _ in range(ROOFLINE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, *rest)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_s = float(np.median(secs))
    terms = RooflineTerms(arch=ROOFLINE_ARCH, cell=cell, mesh="1x1",
                          flops=pred["flops"],
                          hlo_bytes=pred["bytes_accessed"],
                          collective_bytes=0.0)
    ratio = peak / max(pred["temp_size_in_bytes"], 1)
    print(f"roofline {ROOFLINE_ARCH} {cell}: argument bytes predicted "
          f"{pred['argument_size_in_bytes']} {pred['arg_bytes']}, on the "
          f"card {real}; FLOPs predicted {pred['flops']:.0f}, "
          f"FlopCounterMode on the card {flops}; activation peak predicted "
          f"{pred['temp_size_in_bytes']:.0f} B, max_memory_allocated above "
          f"the arguments {peak} B (ratio {ratio:.4f});"
          f" step s predicted (roofline, {terms.bottleneck}) "
          f"{terms.step_time_s:.6f}, measured median of {ROOFLINE_REPS} "
          f"{step_s:.6f} (ratio {step_s / max(terms.step_time_s, 1e-12):.2f})"
          f"; bytes accessed {pred['bytes_accessed']:.0f} (unfused) "
          f"[{card}]")
    _check(fails, real == pred["argument_size_in_bytes"],
           f"roofline {cell}: predicted argument bytes equal the card's")
    _check(fails, flops == pred["flops"],
           f"roofline {cell}: the meta trace's FLOPs equal "
           f"FlopCounterMode's on the card")
    return dict(arg_bytes=real, flops=flops, peak_pred=pred[
        "temp_size_in_bytes"], peak_card=peak, step_s=step_s,
        step_pred_s=terms.step_time_s, bottleneck=terms.bottleneck,
        bytes_accessed=pred["bytes_accessed"])


def _kernel_reports(torch, card, kernels, shapes):
    """``packed_rerank_report`` and ``plaid_probe_report`` at the main
    path's shapes beside the times the kernel checks measured there."""
    from repro_torch.roofline.packed import packed_rerank_report
    from repro_torch.roofline.probe import plaid_probe_report
    by = {k["name"]: k for k in kernels}
    out = {}
    rows = packed_rerank_report(shapes["packed"], bits_list=(shapes["bits"],),
                                cross_check=False)["rows"]
    mp = by["maxsim_packed"]
    for row in rows:
        t = row.pop("terms")
        print(f"roofline packed_rerank at the main path's shape "
              f"{shapes['packed']}: {row['kernel']} bits={row['bits']}: "
              f"flops {row['flops']:.4g}, stream bytes {row['stream_bytes']}"
              f", roofline {t.step_time_s * 1e3:.4f} ms ({t.bottleneck})")
    out["packed"] = dict(rows[-1], path_ms=mp["path_ms"],
                         path_bound_ms=mp["path_bound_ms"])
    print(f"roofline packed_rerank: the kernel at the main path "
          f"{mp['path_ms']:.4f} ms, its own bound {mp['path_bound_ms']:.4f}"
          f" ms (the model prices the TPU kernel's one-hot decode "
          f"{rows[-1]['flop_terms']['decode']:.4g} FLOPs; the CUDA kernel "
          f"gathers) [{card}]")
    rep = plaid_probe_report(shapes["probe"])
    for row in rep["rows"]:
        row.pop("terms")
    host, dev_row = rep["rows"]
    pp = by["plaid_probe"]
    print(f"roofline plaid_probe at the main path's shape {shapes['probe']}"
          f": device fused {dev_row['total_s'] * 1e3:.4f} ms "
          f"({dev_row['bottleneck']}), host path "
          f"{host['total_s'] * 1e3:.4f} ms; the kernel at the main path "
          f"{pp['path_ms']:.4f} ms, its own bound {pp['path_bound_ms']:.4f}"
          f" ms [{card}]")
    out["probe"] = dict(device_s=dev_row["total_s"], host_s=host["total_s"],
                        path_ms=pp["path_ms"],
                        path_bound_ms=pp["path_bound_ms"])
    return out


def roofline_path(rt, torch, dev, card, kernels, shapes):
    """The H100 table against the card; the dry run of dlrm-rm2's four
    cells (the recsys path's shapes) on a one-rank view of the
    production axes, held to the same steps on the card; the packed and
    probe models at the main path's shapes; ``ogb_products`` over the
    fake (16, 16) group, opened and closed around it."""
    from repro_torch.launch.dryrun import run_cell
    t_path = time.perf_counter()
    fails = _checks()
    hw = _hw()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"roofline: total_memory {total} B, hw.HBM_BYTES {hw.HBM_BYTES} B "
          f"[{card}]")
    _check(fails, total == hw.HBM_BYTES,
           "roofline: hw.HBM_BYTES is the card's total_memory")
    cfg = rt.get_config(ROOFLINE_ARCH)
    rng = np.random.default_rng(SEED + 20)

    def run():
        model = rt.init_recsys(cfg, seed=SEED)
        cells = {c: _roofline_cell(rt, torch, dev, cfg, model, c, rng, card,
                                   fails)
                 for c in ("train_batch", "serve_p99", "serve_bulk",
                           "retrieval_cand")}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return cells

    out = {"cells": run_path("roofline", torch, run)}
    out.update(_kernel_reports(torch, card, kernels, shapes))
    t0 = time.perf_counter()
    r = run_cell(*ROOFLINE_DRY, verbose=True)
    stop = r["stage3_stopped"]
    fit = r["argument_size_in_bytes"] + r["temp_size_in_bytes"]
    print(f"roofline dry run {'/'.join(ROOFLINE_DRY)} @ {r['mesh']}: "
          f"{r['note']}; per rank args {r['argument_size_in_bytes']} B, "
          f"activations ({r['per_rank_from']}) {r['temp_size_in_bytes']:.0f}"
          f" B: fits 80 GB ({hw.HBM_BYTES} B) {fit <= hw.HBM_BYTES}; "
          f"global activation peak {r['global']['activation_peak_bytes']} "
          f"B; stage 3 "
          f"{'counted' if stop is None else 'stopped at ' + stop['where']}"
          f"; {time.perf_counter() - t0:.2f}s")
    _check(fails, r["global"] is not None,
           f"roofline: {'/'.join(ROOFLINE_DRY)} stages 1-2 ran")
    _check(fails, stop is None,
           f"roofline: {'/'.join(ROOFLINE_DRY)} stage 3 ran to its end")
    if stop is None:
        print(f"roofline dry run {'/'.join(ROOFLINE_DRY)}: collectives a "
              f"rank {r['collective_bytes']} B: " + ", ".join(
                  f"{op} {e['bytes']} B x{e['count']}"
                  for op, e in r["collectives"].items()))
    out["ogb_products"] = {k: r[k] for k in (
        "argument_size_in_bytes", "temp_size_in_bytes", "per_rank_from",
        "global", "stage3_stopped", "note", "collective_bytes")}
    out["path_s"] = time.perf_counter() - t_path
    print(f"roofline path: {out['path_s']:.2f}s [{card}]")
    _raise_failed("roofline", fails)
    return out


def _one_rank(what, torch, got, want, fails):
    """``got`` (a tree of DTensors from the one-rank mesh) against
    ``want`` (the same call with no context): equal bit for bit, else
    the first leaf that differs and its error are printed."""
    from repro_torch.roofline.analysis import tensors
    pairs = list(zip(tensors(got), tensors(want)))
    bad = [(i, g.to_local(), w) for i, (g, w) in enumerate(pairs)
           if not torch.equal(g.to_local(), w)]
    for i, g, w in bad[:1]:
        err, rel = _errors(g.float(), w.float())
        print(f"sharded: {what}: leaf {i} of {len(pairs)} differs, max abs "
              f"{err:.4g}, relative {rel:.4g}")
    print(f"sharded: {what}: {len(pairs) - len(bad)} of {len(pairs)} "
          f"outputs bit for bit equal to the call without a context")
    _check(fails, not bad, f"sharded: {what} equal without a context")


def sharded_path(rt, torch, dev, card):
    """The models' sharding annotations on the card: a one-rank
    ("data", "model") mesh over NCCL with the reference's rules active
    and the parameters laid out by its parameter rules (DTensors), as
    the dry run's stage 3 runs a step; Qwen3-0.6B's prefill at full
    width and depth and dlrm-rm2's serve step (the row-sharded gather),
    each bit for bit the same call without a context; a kernel wrapper
    handed a DTensor raises with its own name. Then stage 3 at one layer
    over the fake (16, 16) group for each of ``SHARDED_STAGE3``, on this
    machine's torch: each must run to its end; its collectives print."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.dryrun import rank_context, run_cell
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.sharding.api import (P, lm_rules, placements,
                                          recsys_rules)
    from repro_torch.sharding.params import (distribute_params,
                                             lm_param_rules,
                                             recsys_param_rules)
    t_path = time.perf_counter()
    fails = _checks()
    rng = np.random.default_rng(SEED + 30)
    lm_cfg = rt.get_config(LM_ARCH)             # the cells' plain path
    tokens = torch.as_tensor(rng.integers(0, lm_cfg.vocab_size, (
        SHARDED_BATCH, SHARDED_PROMPT)), dtype=torch.int32, device=dev)
    rs_cfg = rt.get_config(ROOFLINE_ARCH)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _recsys_batch(
        rs_cfg, rng, SHARDED_SERVE, label=False).items()}
    specs = {"sparse_ids": P("data", None, None), "dense": P("data", None)}
    out = {}

    def run():
        prefill = rt.make_lm_prefill_step(lm_cfg)
        serve = rt.make_recsys_serve_step(rs_cfg)
        lm = rt.init_transformer(lm_cfg, seed=SEED)
        rs = rt.init_recsys(rs_cfg, seed=SEED)
        with torch.no_grad():
            want_lm = prefill(lm, {"tokens": tokens})
            want_rs = serve(rs, batch)
        with process_group(dev):
            mesh = make_mesh((1, 1), ("data", "model"), dev)
            distribute_params(lm, mesh, lm_param_rules("data"))
            distribute_params(rs, mesh, recsys_param_rules(None))
            with torch.no_grad():
                with rank_context(mesh, lm_rules("data")):
                    t0 = time.perf_counter()
                    got_lm = prefill(lm, {"tokens": distribute_tensor(
                        tokens, mesh, placements(P("data", None), mesh))})
                    torch.cuda.synchronize()
                    out["lm_s"] = time.perf_counter() - t0
                with rank_context(mesh, recsys_rules("data")):
                    got_rs = serve(rs, {k: distribute_tensor(
                        v, mesh, placements(specs[k], mesh))
                        for k, v in batch.items()})
                q = distribute_tensor(torch.zeros(
                    1, 2, 64, 64, dtype=torch.bfloat16, device=dev), mesh,
                    placements(P(), mesh))
                try:
                    flash_attention(q, q, q, causal=True)
                    refused = ""
                except TypeError as e:
                    refused = str(e)
            torch.cuda.synchronize()
        _one_rank(f"{LM_ARCH} prefill ({SHARDED_BATCH} x {SHARDED_PROMPT}, "
                  f"{lm_cfg.n_layers} layers, {lm_cfg.dtype}; logits and "
                  f"the cache)", torch, got_lm, want_lm, fails)
        _one_rank(f"{ROOFLINE_ARCH} serve ({SHARDED_SERVE})", torch,
                  got_rs, want_rs, fails)
        _check(fails, isinstance(got_lm[0], DTensor)
               and isinstance(got_rs, DTensor),
               "sharded: the steps ran over DTensors")
        print(f"sharded: flash_attention handed a DTensor: "
              f"{refused or 'no error'}")
        _check(fails, refused.startswith("flash_attention:"),
               "sharded: a kernel wrapper refuses a DTensor by its name")
        del lm, rs, got_lm, got_rs, want_lm, want_rs
        gc.collect()
        torch.cuda.empty_cache()

    run_path("sharded", torch, run)
    cells = {}
    for arch, cell in SHARDED_STAGE3:
        r = run_cell(arch, cell, layers_override=1, verbose=False)
        stop = r["stage3_stopped"]
        coll = ("stopped at " + stop["where"] + f" ({stop['op']}: "
                f"{stop['error']})" if stop else
                f"{r['collective_bytes']} B: " + ", ".join(
                    f"{op} {e['bytes']} B x{e['count']}"
                    for op, e in r["collectives"].items()))
        print(f"sharded: stage 3 {arch} {cell} @ {r['mesh']}, 1 layer, "
              f"torch {torch.__version__}: {coll}; {sum(r['stage_s']):.1f}s")
        _check(fails, r["ok"], f"sharded: stage 3 of {arch} {cell} ran to "
                               f"its end")
        cells[f"{arch}/{cell}"] = r["collective_bytes"]
    out.update(cells=cells, path_s=time.perf_counter() - t_path)
    print(f"sharded path: {out['path_s']:.2f}s [{card}]")
    _raise_failed("sharded", fails)
    return out


def check_flash_attention(torch, dev):
    """The kernel against its plain version on seeded random inputs, then
    timed at the lm path's per-layer shape with the plain version and
    ``scaled_dot_product_attention`` (library_ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    errs = FLASH_ERRS
    for what, B, H, KV, Sq, Skv, dh, causal, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (rand((B, H, Sq, dh), dt), rand((B, KV, Skv, dh), dt),
                   rand((B, KV, Skv, dh), dt))
        got = flash_attention(q, k, v, causal=causal).float()
        want = flash_attention(q, k, v, causal=causal, impl="ref").float()
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        err = float((got - want).abs().max())
        errs.append(err)
        print(f"flash_attention {what} (B={B}, Sq={Sq}, Skv={Skv}, "
              f"{dtype}, causal={causal}): max abs err {err:.4g} (atol = "
              f"rtol = {tol})")
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {what}: disagrees")
        if causal and Sq > Skv:
            n0 = Sq - Skv
            if got[:, :, :n0].any() or want[:, :, :n0].any():
                raise AssertionError("flash_attention: rows that see no "
                                     "column are not 0")
            print(f"flash_attention {what}: the first {n0} rows are "
                  f"exactly 0 on both")
        del q, k, v, got, want
    # timed at the lm path's per-layer shape, in the model's layout (the
    # [B, S, heads, dh] projections seen as [B, heads, S, dh])
    B, H, KV, S, dh = LM_BATCH, 16, 8, LM_PROMPT, 64
    q, k, v = (rand((B, S, n, dh), torch.bfloat16).transpose(1, 2)
               for n in (H, KV, KV))
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
        kl, vl, gqa = k, v, dict(enable_gqa=True)
    except TypeError:                # no enable_gqa: repeat outside timing
        kl = k.repeat_interleave(H // KV, dim=1)
        vl = v.repeat_interleave(H // KV, dim=1)
        gqa = {}
    pairs = B * H * S * (S + 1) // 2
    flop = 4 * dh * pairs
    ms = _time_ms(lambda: flash_attention(q, k, v, causal=True), reps=20)
    plain_ms = _time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                impl="ref"))
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, kl, vl, is_causal=True, **gqa), reps=20)
    got = flash_attention(q, k, v, causal=True).float()
    want = flash_attention(q, k, v, causal=True, impl="ref").float()
    tol = FLASH_TOL["bfloat16"]
    errs.append(float((got - want).abs().max()))
    print(f"flash_attention timed lm shape (B={B}, S={S}, bf16, causal): "
          f"max abs err {errs[-1]:.4g} (atol = rtol = {tol})")
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError("flash_attention: disagrees at the lm shape")
    del got, want
    bound, by = _bound_ms(_nbytes(q, k, v) + q.numel() * q.element_size(),
                          flop, _hw().PEAK_FLOPS_BF16)
    print(f"flash_attention at the lm shape: {ms:.4f} ms, "
          f"{flop / ms / 1e9:.1f} TFLOP/s ({flop / 1e9:.2f} GFLOP of visible "
          f"pairs); scaled_dot_product_attention {library_ms:.4f} ms "
          f"({flop / library_ms / 1e9:.1f} TFLOP/s): "
          f"{ms / library_ms:.2f}x its time; {_hmma_count('flash_attention')}")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:91",
                **_launches("flash_attention"), max_abs_err=max(errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms,
                check=f"allclose atol = rtol {FLASH_TOL['float32']} (f32), "
                      f"{FLASH_TOL['bfloat16']} (bf16) in {len(FLASH_CASES)} "
                      f"cases ({', '.join(c[0] for c in FLASH_CASES)}), at "
                      f"the timed lm shape, and on the first and last "
                      f"layer's own q, k, v of the lm and lm_long paths; "
                      f"rows that see no column exactly 0; timed at q "
                      f"[{B * H}, {S}, {dh}], "
                      f"k/v [{B * KV}, {S}, {dh}] bf16 causal; bound: bf16 "
                      f"peak, 4 dh x {pairs} visible pairs; library_ms: "
                      f"scaled_dot_product_attention(is_causal=True"
                      f"{', enable_gqa=True' if gqa else ', k/v repeated'})")


def _hmma_count(name: str, kernel: str = "") -> str:
    """HMMA (tensor-core) instructions in the built library of
    ``csrc/<name>.cu``, by ``cuobjdump -sass``: in all, and in each of its
    functions whose (mangled) name holds ``kernel``; fails on none."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise AssertionError(f"cuobjdump not found: the {name} library's "
                             f"HMMA instructions cannot be counted")
    sass = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    per_fn, fn = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif " HMMA." in line:
            per_fn[fn] = per_fn.get(fn, 0) + 1
    n = sum(per_fn.values())
    if n == 0:
        raise AssertionError(f"{name}: no HMMA instruction in its SASS")
    if not kernel:
        return f"SASS has {n} HMMA instructions (cuobjdump -sass)"
    each = {f: c for f, c in per_fn.items() if kernel in f}
    if not each:
        raise AssertionError(f"{name}: no HMMA instruction in {kernel}")
    return (f"SASS has {n} HMMA instructions (cuobjdump -sass), by "
            f"{kernel} instance: " + ", ".join(
                f"{f} {c}" for f, c in sorted(each.items())))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="",
                    help="a directory inside this checkout holding an "
                         "earlier checkout's src/repro_torch/csrc whose "
                         "kernels declare PARENT_ABI; timed beside this "
                         "one's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import repro_torch as rt
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    # f32 products and convolutions in full f32 (no TF32) everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    (index, stats, model, docs, searcher, queries, qrels, S,
     I) = main_path(rt, torch, dev)
    persist_path(rt, torch, model, queries, stats, S, I)
    facade_path(rt, torch, model, queries, S, I)
    host_probe_path(torch, index, searcher, queries, S, I)
    dense_path(rt, torch, model, docs, queries)
    flat_args, flat_index = flat_path(rt, torch, model, docs, queries)
    recon_args = recon_path(torch, index, searcher, queries, S, I)
    mutate_path(rt, torch, model, queries)
    surface_path(rt, torch, model, docs, queries, index, searcher)
    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    hnsw_path(rt, torch, model, docs, queries)
    k8192_probe = plaid_k8192_path(rt, torch, model, flat_index, queries)
    sharding_numbers = sharding_path(rt, torch, dev, card, model, flat_index,
                                     queries)
    del flat_index
    kmeans_path(rt, torch, model, docs, queries)
    sequential_path(rt, torch, model, docs, queries)
    cascade, cS, cI, cascade_args = cascade_path(rt, torch, model, docs,
                                                 queries)
    cascade_from_dir_path(rt, torch, model, queries, cascade, cS, cI)
    del cascade
    stream_path(rt, torch, model, docs, queries, card)
    stream_parity_path(rt, torch, model, docs, queries, card)
    eval_numbers = eval_path(rt, torch, dev, model, docs, queries, qrels,
                             searcher)
    serve_numbers = serve_path(rt, torch, model, index, searcher, queries)
    examples_numbers = examples_path(rt, torch, dev, card)
    gc.collect()                    # the sharded indexes go before the LM
    torch.cuda.empty_cache()
    lm_cfg, lm = _lm_model(rt, torch)
    lm_path(rt, torch, lm_cfg, lm)
    lm_long_path(rt, torch, lm_cfg, lm)
    del lm
    torch.cuda.empty_cache()

    parent = parent_kernels(args.parent)
    path_probe, path_packed, path_qv = capture_path_args(torch, searcher,
                                                         queries)
    report_shapes = _report_shapes(index, path_probe, path_packed)
    split = search_split(torch, searcher, path_qv)
    index.packed_rerank = False
    recon_split = search_split(torch, searcher, path_qv, RECON_STAGES,
                               "recon_rerank")
    index.packed_rerank = True
    qv = searcher.encode_queries(queries[:QUERY_BATCH])
    kernels = [check_ward(torch, dev),
               check_plaid_probe(torch, dev, index, qv, path_probe,
                                 k8192_probe, parent),
               check_maxsim_packed(torch, dev, index, qv, path_packed, parent),
               check_maxsim(torch, dev, index, qv, flat_args, parent),
               check_maxsim_rerank(torch, dev, index, qv, recon_args,
                                   cascade_args, parent),
               check_kmeans_assign(torch, dev, model, docs, parent),
               check_dequant_score(torch, dev, index, qv, parent),
               check_flash_attention(torch, dev)]
    for k in kernels:
        lib = (f", library {k['library_ms']:.4f} ms" if k["library_ms"]
               is not None else "")
        print(f"kernel {k['name']}: {k.pop('check')}; {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms{lib}, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']})")

    _agree("main path vs plain versions", S, I,
           *_search_all(searcher, queries, impl="ref"))
    query_graph = query_graph_row(rt, torch, dev)
    # the train paths come last: their profiled steps open profiler
    # sessions of their own, after which ``search_split`` found no
    # device time in its ranges
    gc.collect()
    torch.cuda.empty_cache()
    colbert_train = colbert_train_path(rt, torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    lm_train = lm_train_path(rt, torch, dev, card)
    train_mesh = train_mesh_path(rt, torch, dev, card)
    build_loop_profile(rt, torch, model, docs, card)
    del index, searcher, model
    gc.collect()
    torch.cuda.empty_cache()
    sharding_numbers.update(sharding_ep(rt, torch, dev, card))
    moe_numbers = moe_path(rt, torch, dev, card)
    gnn_numbers = gnn_path(rt, torch, dev, card)
    recsys_numbers = recsys_path(rt, torch, dev, card)
    roofline_numbers = roofline_path(rt, torch, dev, card, kernels,
                                     report_shapes)
    sharded_numbers = sharded_path(rt, torch, dev, card)
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash.update(_launches("flash_attention"))

    print(json.dumps({"kernels": kernels, "search_split_ms": split,
                      "recon_split_ms": recon_split, "eval": eval_numbers,
                      "serve": serve_numbers, "colbert_train": colbert_train,
                      "lm_train": lm_train, "train_mesh": train_mesh,
                      "moe": moe_numbers,
                      "sharding": sharding_numbers,
                      "gnn": gnn_numbers, "recsys": recsys_numbers,
                      "roofline": roofline_numbers,
                      "sharded": sharded_numbers, "main": MAIN_NUMBERS,
                      "surface": SURFACE,
                      "examples": examples_numbers,
                      "query_graph": query_graph, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
