"""Serving steps of the causal LM (``src/repro/launch/steps.py``
``make_lm_prefill_step`` and ``make_lm_decode_step``).

A builder takes the config that decides the attention path (so
``dataclasses.replace(cfg, use_flash_kernel=True)`` runs the prefill
through the ``flash_attention`` kernel) and the device the batches go
to: ``cuda`` unless the caller passes one, raising without a card. The
steps take the model in place of the reference's parameter tree and run
without autograd. Training steps are not ported yet.
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
