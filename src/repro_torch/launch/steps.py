"""Steps of the causal LM (``src/repro/launch/steps.py``
``make_lm_train_step``, ``make_lm_prefill_step``,
``make_lm_decode_step``) and of ColBERT retrieval
(``make_colbert_index_step``, ``make_colbert_search_step``).

A builder takes the config that decides the attention path (so
``dataclasses.replace(cfg, use_flash_kernel=True)`` runs the prefill
through the ``flash_attention`` kernel) and the device the batches go
to: ``cuda`` unless the caller passes one, raising without a card. The
steps take the model in place of the reference's parameter tree; the
serving steps run without autograd.

The train step (``lm_grads``, then the clip and the optimizer) takes
the gradient of ``lm_loss`` by autograd over ``cfg.train_microbatches``
slices of the batch, summed in ``cfg.grad_accum_dtype``, and updates the
model in place. It refuses ``use_flash_kernel``: the kernel has no
backward, in either package.

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


def lm_grads(model, tokens: torch.Tensor, labels: torch.Tensor, cfg):
    """The loss and gradient (in the model's groups) of ``lm_loss`` on
    one batch: at ``cfg.train_microbatches`` > 1 the mean loss and the
    gradients of its consecutive slices summed in ``cfg.grad_accum_dtype``
    and divided by their count, as the reference's scan does."""
    from repro_torch.models.layers import dt
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.params import microbatch_value_and_grad

    def loss_fn(m, b):
        return lm_loss(m, b["tokens"], b["labels"], cfg)

    loss, _, grads = microbatch_value_and_grad(
        loss_fn, model, {"tokens": tokens, "labels": labels},
        cfg.train_microbatches, dt(cfg.grad_accum_dtype))
    return loss, grads


def make_lm_train_step(cfg, lr: float = 1e-4, *,
                       device: DeviceLike = None):
    """-> (train_step, opt): ``train_step(model, opt_state, batch{"tokens",
    "labels" [B, S]}) -> (opt_state, {"loss", "grad_norm"})``, the model
    updated in place; the gradient clipped to a global norm of 1.0 (the
    norm reported is the one before the clip), then ``cfg.optimizer`` at
    a constant ``lr``."""
    from repro_torch.train.optimizer import (clip_by_global_norm,
                                             make_optimizer)
    from repro_torch.train.params import param_groups
    _check_lm(cfg)
    if cfg.use_flash_kernel:
        raise ValueError(
            f"{cfg.name}: use_flash_kernel has no train step: the "
            f"flash_attention kernel has no backward, in either package")
    dev = resolve_device(device)
    opt = make_optimizer(cfg.optimizer, lr)

    def train_step(model, opt_state, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        loss, grads = lm_grads(model, tokens, labels, cfg)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        opt_state = opt.update(param_groups(model), grads, opt_state)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt


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
