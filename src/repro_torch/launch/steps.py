"""The step builders of ``src/repro/launch/steps.py``: the causal LM's
(``make_lm_train_step``, ``make_lm_prefill_step``,
``make_lm_decode_step``; dense and MoE trunks, ``moe_impl`` passed
through), DimeNet's (``make_gnn_train_step``), the recsys models'
(``make_recsys_train_step``, ``make_recsys_serve_step``,
``make_recsys_retrieval_step``) and ColBERT retrieval's
(``make_colbert_index_step``, ``make_colbert_search_step``).

A builder takes the config that decides the attention path (so
``dataclasses.replace(cfg, use_flash_kernel=True)`` runs the prefill
through the ``flash_attention`` kernel) and the device the batches go
to: ``cuda`` unless the caller passes one, raising without a card. The
steps take the model in place of the reference's parameter tree; the
serving steps run without autograd.

The train steps take the gradient by autograd, clip it to a global norm
of 1.0 (returning the norm before the clip) and update the model in
place with ``cfg.optimizer`` at a constant ``lr``. The LM's (``lm_grads``)
runs over ``cfg.train_microbatches`` slices of the batch, summed in
``cfg.grad_accum_dtype``, and refuses ``use_flash_kernel``: the kernel
has no backward, in either package.

The ColBERT steps: the index step encodes a doc batch and pools it
(Ward through the ``ward_pool`` kernel); the search step encodes the
queries, scores every doc with the ``maxsim`` kernel
(``maxsim_all_docs``, for both ``maxsim_impl`` values: the kernel
streams doc blocks through shared memory either way) and takes the
top-k with ties to the lowest doc id (``stable_topk``). On ``meta``
tensors (the dry run's trace; no kernel runs there) it scores with the
plain version as the reference's step does: ``"einsum"`` in one pass
over all docs, ``"blocked"`` in blocks of ``cfg.maxsim_block``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import DeviceLike, resolve_device


def lm_grads(model, tokens: torch.Tensor, labels: torch.Tensor, cfg,
             moe_impl: str = None):
    """The loss and gradient (in the model's groups) of ``lm_loss`` on
    one batch: at ``cfg.train_microbatches`` > 1 the mean loss and the
    gradients of its consecutive slices summed in ``cfg.grad_accum_dtype``
    and divided by their count, as the reference's scan does.
    ``moe_impl`` defaults to ``cfg.moe_impl``."""
    from repro_torch.models.layers import dt
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.params import microbatch_value_and_grad
    moe_impl = moe_impl or cfg.moe_impl

    def loss_fn(m, b):
        return lm_loss(m, b["tokens"], b["labels"], cfg, moe_impl=moe_impl)

    loss, _, grads = microbatch_value_and_grad(
        loss_fn, model, {"tokens": tokens, "labels": labels},
        cfg.train_microbatches, dt(cfg.grad_accum_dtype))
    return loss, grads


def make_lm_train_step(cfg, lr: float = 1e-4, moe_impl: str = None, *,
                       device: DeviceLike = None):
    """-> (train_step, opt): ``train_step(model, opt_state, batch{"tokens",
    "labels" [B, S]}) -> (opt_state, {"loss", "grad_norm"})``, the model
    updated in place; the gradient clipped to a global norm of 1.0 (the
    norm reported is the one before the clip), then ``cfg.optimizer`` at
    a constant ``lr``. ``moe_impl`` defaults to ``cfg.moe_impl``."""
    from repro_torch.train.optimizer import make_optimizer
    if cfg.use_flash_kernel:
        raise ValueError(
            f"{cfg.name}: use_flash_kernel has no train step: the "
            f"flash_attention kernel has no backward, in either package")
    dev = resolve_device(device)
    opt = make_optimizer(cfg.optimizer, lr)

    def train_step(model, opt_state, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        loss, grads = lm_grads(model, tokens, labels, cfg, moe_impl)
        opt_state, gnorm = _update(opt, model, opt_state, grads)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt


def make_lm_prefill_step(cfg, moe_impl: str = None, *, max_len: int = None,
                         device: DeviceLike = None) -> Callable:
    """prefill_step(model, batch{"tokens" [B, S]}) -> (last-token logits
    [B, V], cache {"k", "v"} [L, B, max_len, KV, dh]); ``max_len``
    defaults to S, as in the reference; ``moe_impl`` to
    ``cfg.moe_impl``."""
    dev = resolve_device(device)
    moe_impl = moe_impl or cfg.moe_impl

    def prefill_step(model, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        hidden, cache = model.prefill(tokens, max_len, cfg=cfg,
                                      moe_impl=moe_impl)
        with torch.no_grad():
            logits = model.logits_head(hidden[:, -1:, :])
        return logits[:, 0, :], cache

    return prefill_step


def make_lm_decode_step(cfg, moe_impl: str = None, *,
                        device: DeviceLike = None) -> Callable:
    """decode_step(model, cache, batch{"token" [B, 1], "pos" int}) ->
    (logits [B, V], cache): one new token against the cache, its k and v
    written at ``pos`` in place; ``moe_impl`` defaults to
    ``cfg.moe_impl``."""
    dev = resolve_device(device)
    moe_impl = moe_impl or cfg.moe_impl

    def decode_step(model, cache, batch):
        token = torch.as_tensor(batch["token"], device=dev)
        logits, cache = model.decode_step(token, cache, batch["pos"],
                                          cfg=cfg, moe_impl=moe_impl)
        return logits[:, 0, :], cache

    return decode_step


def _update(opt, model, opt_state, grads):
    """Clip to a global norm of 1.0, then the optimizer, in place ->
    (opt_state, the norm before the clip)."""
    from repro_torch.train.optimizer import clip_by_global_norm
    from repro_torch.train.params import param_groups
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    return opt.update(param_groups(model), grads, opt_state), gnorm


def make_gnn_train_step(cfg, task: str, n_graphs: int = 1, lr: float = 1e-3,
                        *, device: DeviceLike = None):
    """-> (train_step, opt): ``train_step(model, opt_state, batch) ->
    (opt_state, {"loss", "grad_norm"})``; the batch holds
    ``dimenet_forward``'s inputs and ``targets`` ([n_graphs, t] f32 for
    ``task="graph"``, [N] labels for ``"node"``)."""
    from repro_torch.models.gnn.dimenet import dimenet_loss
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.params import value_and_grad
    dev = resolve_device(device)
    opt = make_optimizer(cfg.optimizer, lr)

    def loss_fn(model, batch):
        inputs = {k: v for k, v in batch.items() if k != "targets"}
        return dimenet_loss(model, inputs, batch["targets"], cfg, task=task,
                            n_graphs=n_graphs), {}

    def train_step(model, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, _, grads = value_and_grad(loss_fn, model, batch)
        opt_state, gnorm = _update(opt, model, opt_state, grads)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt


def make_recsys_train_step(cfg, lr: float = 1e-3, *,
                           device: DeviceLike = None):
    """-> (train_step, opt): ``train_step(model, opt_state,
    batch{"sparse_ids", "dense" (if the model has them), "label"}) ->
    (opt_state, {"loss", "grad_norm"})``; AdamW updates every row of
    every table (dense gradients, as the reference's)."""
    from repro_torch.models.recsys.models import recsys_loss
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.params import value_and_grad
    dev = resolve_device(device)
    opt = make_optimizer(cfg.optimizer, lr)

    def train_step(model, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, _, grads = value_and_grad(
            lambda m, b: recsys_loss(m, b, cfg), model, batch)
        opt_state, gnorm = _update(opt, model, opt_state, grads)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt


def make_recsys_serve_step(cfg, *, device: DeviceLike = None) -> Callable:
    """serve_step(model, batch{"sparse_ids", "dense"}) -> CTR logits [B]."""
    from repro_torch.models.recsys.models import recsys_forward
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(model, batch):
        return recsys_forward(model, {k: torch.as_tensor(v, device=dev)
                                      for k, v in batch.items()}, cfg)

    return serve_step


def make_recsys_retrieval_step(cfg, k: int = 100, *,
                               device: DeviceLike = None) -> Callable:
    """retrieval_step(model, batch{"sparse_ids", "candidates" [C, D]}) ->
    (scores [B, k], ids [B, k]), ties to the lower candidate id."""
    from repro_torch.models.recsys.models import score_candidates
    dev = resolve_device(device)

    @torch.no_grad()
    def retrieval_step(model, batch):
        return score_candidates(
            model, {"sparse_ids": torch.as_tensor(batch["sparse_ids"],
                                                  device=dev)},
            torch.as_tensor(batch["candidates"], device=dev), cfg, k=k)

    return retrieval_step


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
    from repro_torch.core.maxsim import maxsim_scores, stable_topk
    from repro_torch.models.colbert import encode_queries
    if cfg.maxsim_impl not in ("einsum", "blocked"):
        raise ValueError(f"maxsim_impl must be einsum|blocked, got "
                         f"{cfg.maxsim_impl!r}")
    dev = resolve_device(device)
    block = cfg.maxsim_block if cfg.maxsim_impl == "blocked" else None

    def search_step(model, batch):
        qv, qm = encode_queries(model, torch.as_tensor(batch["q_tokens"],
                                                       device=dev))
        d = torch.as_tensor(batch["doc_vecs"], device=dev)
        dm = torch.as_tensor(batch["doc_mask"], device=dev).bool()
        return stable_topk(maxsim_scores(qv, qm, d, dm, block), k)

    return search_step
