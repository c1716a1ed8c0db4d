"""Serving steps of the causal LM (``src/repro/launch/steps.py``
``make_lm_prefill_step`` and ``make_lm_decode_step``) and of ColBERT
retrieval (``make_colbert_index_step``, ``make_colbert_search_step``).

A builder takes the config that decides the attention path (so
``dataclasses.replace(cfg, use_flash_kernel=True)`` runs the prefill
through the ``flash_attention`` kernel) and the device the batches go
to: ``cuda`` unless the caller passes one, raising without a card. The
steps take the model in place of the reference's parameter tree and run
without autograd. Training steps are not ported yet.

The ColBERT steps: the index step encodes a doc batch and pools it
(Ward through the ``ward_pool`` kernel); the search step encodes the
queries, scores every doc with the ``maxsim`` kernel
(``maxsim_all_docs``, for both ``maxsim_impl`` values: the kernel
streams doc blocks through shared memory either way) and takes the
top-k with ties to the lowest doc id (``stable_topk``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import DeviceLike, resolve_device


def _check_lm(cfg) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE trunks (models/moe.py) are not ported yet "
            f"(ROADMAP queue 1)")


def make_lm_prefill_step(cfg, *, max_len: int = None,
                         device: DeviceLike = None) -> Callable:
    """prefill_step(model, batch{"tokens" [B, S]}) -> (last-token logits
    [B, V], cache {"k", "v"} [L, B, max_len, KV, dh]); ``max_len``
    defaults to S, as in the reference."""
    _check_lm(cfg)
    dev = resolve_device(device)

    def prefill_step(model, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        hidden, cache = model.prefill(tokens, max_len, cfg=cfg)
        with torch.no_grad():
            logits = model.logits_head(hidden[:, -1:, :])
        return logits[:, 0, :], cache

    return prefill_step


def make_lm_decode_step(cfg, *, device: DeviceLike = None) -> Callable:
    """decode_step(model, cache, batch{"token" [B, 1], "pos" int}) ->
    (logits [B, V], cache): one new token against the cache, its k and v
    written at ``pos`` in place."""
    _check_lm(cfg)
    dev = resolve_device(device)

    def decode_step(model, cache, batch):
        token = torch.as_tensor(batch["token"], device=dev)
        logits, cache = model.decode_step(token, cache, batch["pos"],
                                          cfg=cfg)
        return logits[:, 0, :], cache

    return decode_step


def make_colbert_index_step(cfg, *, device: DeviceLike = None) -> Callable:
    """index_step(model, batch{"doc_tokens" [B, L]}) -> (pooled
    [B, N, dim], pooled_mask [B, N]): encode, then pool at
    ``cfg.pool_factor`` with ``cfg.pool_method``."""
    from repro_torch.core.pooling import pool_doc_embeddings
    from repro_torch.models.colbert import encode_docs
    dev = resolve_device(device)

    def index_step(model, batch):
        v, emit = encode_docs(model, torch.as_tensor(batch["doc_tokens"],
                                                     device=dev))
        method = "none" if cfg.pool_factor <= 1 else cfg.pool_method
        return pool_doc_embeddings(v, emit, max(cfg.pool_factor, 1), method)

    return index_step


def make_colbert_search_step(cfg, k: int = 10, *,
                             device: DeviceLike = None) -> Callable:
    """search_step(model, batch{"q_tokens" [Nq, L], "doc_vecs"
    [Nd, Ld, dim], "doc_mask" [Nd, Ld]}) -> (scores [Nq, k], ids
    [Nq, k]) on the device."""
    from repro_torch.core.maxsim import maxsim_all_docs, stable_topk
    from repro_torch.models.colbert import encode_queries
    if cfg.maxsim_impl not in ("einsum", "blocked"):
        raise ValueError(f"maxsim_impl must be einsum|blocked, got "
                         f"{cfg.maxsim_impl!r}")
    dev = resolve_device(device)

    def search_step(model, batch):
        qv, qm = encode_queries(model, torch.as_tensor(batch["q_tokens"],
                                                       device=dev))
        d = torch.as_tensor(batch["doc_vecs"], device=dev).float()
        dm = torch.as_tensor(batch["doc_mask"], device=dev).bool()
        scores = maxsim_all_docs(qv, qm, d.contiguous(), dm.contiguous())
        return stable_topk(scores, k)

    return search_step
