"""ColBERT encoder (Khattab & Zaharia, 2020) as a PyTorch module.

Counterpart of ``src/repro/models/colbert.py``: a bidirectional trunk,
a linear projection to ``proj_dim`` and L2 normalization.

  * ``[Q]``/``[D]`` marker after ``[CLS]``; queries are padded to
    ``query_maxlen`` with ``[MASK]`` tokens that attend and emit vectors.
  * Document punctuation tokens do not emit stored vectors.

``init_colbert`` draws random weights from a seeded ``torch.Generator``
with the reference initializers' distributions; ``params_from_jax``
turns the reference's parameter tree into this module's state and
``params_to_jax`` back.

Training: ``colbert_loss``, the in-batch-negative contrastive loss over
MaxSim scores (ColBERTv2's objective without distillation), and
``colbert_train_step``. ``encode_queries`` / ``encode_docs`` run without
autograd; the loss encodes with it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Dense, Embed, dt
from repro_torch.models.transformer import Transformer
from repro_torch.models.transformer import params_from_jax as trunk_params
from repro_torch.models.transformer import params_to_jax as trunk_to_jax
from repro_torch.sharding.api import constrain
from repro_torch.train.params import host, param_groups, value_and_grad

# Special token ids (data/tokenizer.py — shared vocabulary layout)
PAD_ID, CLS_ID, SEP_ID, MASK_ID, Q_MARK_ID, D_MARK_ID = 0, 1, 2, 3, 4, 5
N_SPECIAL = 8          # ids < N_SPECIAL are special
N_PUNCT = 16           # ids in [N_SPECIAL, N_SPECIAL + N_PUNCT) are punctuation


class ColBERT(nn.Module):
    """cfg: ColbertConfig. ``forward(tokens, pad_mask)`` -> unit vectors."""

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.trunk = Transformer(cfg.trunk, device)
        self.proj = Dense(cfg.trunk.d_model, cfg.proj_dim, False, device,
                          dt(cfg.trunk.param_dtype))

    @property
    def device(self) -> torch.device:
        return self.proj.w.device

    def forward(self, tokens: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] -> unit vectors [B, L, proj_dim] f32."""
        v = self.proj(self.trunk(tokens, pad_mask)).float()
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), min=1e-9)
        return constrain(v, "batch", "seq", None)

    def load_params(self, state: Dict[str, np.ndarray]) -> "ColBERT":
        """Load a ``params_from_jax`` state (numpy arrays) in place."""
        self.load_state_dict({k: torch.as_tensor(np.array(v))
                              for k, v in state.items()}, strict=True)
        return self


def init_colbert(cfg, generator: Optional[torch.Generator] = None, *,
                 seed: int = 0, device: DeviceLike = None) -> ColBERT:
    """Random weights: embeddings truncated-normal(0.02), dense weights
    normal(1/sqrt(d_in)), zero biases, unit norms. ``generator`` (on the
    model's device) defaults to one seeded with ``seed``."""
    model = ColBERT(cfg, device)
    if model.device.type == "meta":     # shapes only: nothing to draw
        return model
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Dense, Embed)):
            m.reset_parameters(generator)
    return model


def params_from_jax(tree) -> Dict[str, np.ndarray]:
    """The reference's ``init_colbert`` tree (``trunk``: an
    ``init_transformer`` tree; ``proj``) -> this module's state, as numpy
    arrays. The trunk's ``lm_head`` is not part of the encoder and is
    dropped."""
    trunk = {k: v for k, v in tree["trunk"].items() if k != "lm_head"}
    state = trunk_params(trunk, prefix="trunk.")
    state["proj.w"] = np.asarray(tree["proj"]["w"])
    return state


def params_to_jax(state) -> Dict:
    """The inverse of ``params_from_jax``: this module's state (tensors
    or arrays) -> the reference's ``{trunk, proj}`` tree of host arrays,
    the trunk's layers stacked (no ``lm_head``: the encoder has none)."""
    return {"trunk": trunk_to_jax(state, prefix="trunk."),
            "proj": {"w": host(state["proj.w"])}}


def _head(B: int, mark: int, device) -> torch.Tensor:
    """[B, 2] of [CLS][mark], filled on ``device`` (a tensor made from a
    host list would be a blocking copy, which waits for the queue)."""
    head = torch.empty((B, 2), dtype=torch.int32, device=device)
    head[:, 0] = CLS_ID
    head[:, 1] = mark
    return head


def prepare_query_tokens(tokens: torch.Tensor, query_maxlen: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] raw ids -> ([B, Lq] [CLS][Q] body, PAD slots as [MASK];
    attention mask all True — the expansion tokens attend)."""
    B = tokens.shape[0]
    body_len = query_maxlen - 2
    body = tokens[:, :body_len].to(torch.int32)
    if body.shape[1] < body_len:
        body = torch.nn.functional.pad(body, (0, body_len - body.shape[1]))
    body = torch.where(body == PAD_ID, torch.full_like(body, MASK_ID), body)
    head = _head(B, Q_MARK_ID, tokens.device)
    out = torch.cat([head, body], dim=1)
    return out, torch.ones(out.shape, dtype=torch.bool, device=out.device)


def prepare_doc_tokens(tokens: torch.Tensor, doc_maxlen: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] raw ids -> ([B, Ld] with [CLS][D] prefix, pad mask)."""
    B = tokens.shape[0]
    body_len = doc_maxlen - 2
    body = tokens[:, :body_len].to(torch.int32)
    if body.shape[1] < body_len:
        body = torch.nn.functional.pad(body, (0, body_len - body.shape[1]))
    head = _head(B, D_MARK_ID, tokens.device)
    out = torch.cat([head, body], dim=1)
    return out, out != PAD_ID


def emit_mask_docs(tokens: torch.Tensor, pad_mask: torch.Tensor,
                   mask_punctuation: bool) -> torch.Tensor:
    """Doc positions that emit stored vectors: real, non-punctuation
    tokens (the CLS/[D] markers included, as in ColBERT's skiplist)."""
    if not mask_punctuation:
        return pad_mask
    punct = (tokens >= N_SPECIAL) & (tokens < N_SPECIAL + N_PUNCT)
    return pad_mask & ~punct


def _ids(model: ColBERT, tokens) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                           else tokens, device=model.device)


def _encode_queries(model: ColBERT, tokens):
    toks, attn = prepare_query_tokens(_ids(model, tokens),
                                      model.cfg.query_maxlen)
    return model(toks, attn), torch.ones_like(attn)


def _encode_docs(model: ColBERT, tokens):
    toks, attn = prepare_doc_tokens(_ids(model, tokens), model.cfg.doc_maxlen)
    v = model(toks, attn)
    emit = emit_mask_docs(toks, attn, model.cfg.mask_punctuation)
    return torch.where(emit[..., None], v, torch.zeros((), device=v.device)), emit


@torch.no_grad()
def encode_queries(model: ColBERT, tokens):
    """Raw query ids [B, L] -> ([B, Lq, dim] unit vectors, emit mask);
    every expanded slot emits."""
    return _encode_queries(model, tokens)


@torch.no_grad()
def encode_docs(model: ColBERT, tokens):
    """Raw doc ids [B, L] -> ([B, Ld, dim] unit vectors, emit mask);
    non-emitting slots are zero."""
    return _encode_docs(model, tokens)


# ---------------------------------------------------------------------------
# Training objective: in-batch-negative contrastive MaxSim
# ---------------------------------------------------------------------------
def colbert_loss(model: ColBERT, q_tokens, d_tokens):
    """q_tokens [B, Lq0], d_tokens [B, Ld0] raw ids; positives on the
    diagonal -> (loss, {"loss", "acc"}) over the full [B, B] in-batch
    MaxSim (plain torch, as the reference's ``einsum``; encoded with
    autograd, the trunk's blocks recomputed in backward under
    ``remat``)."""
    qv, qm = _encode_queries(model, q_tokens)
    dv, dm = _encode_docs(model, d_tokens)
    sim = torch.einsum("qld,nkd->qnlk", qv, dv)          # [B, B, Lq, Ld]
    sim = sim.masked_fill(~dm[None, :, None, :], float("-inf"))
    best = sim.amax(dim=-1)
    best = torch.where(qm[:, None, :] & torch.isfinite(best), best,
                       torch.zeros((), device=best.device))
    scores = best.sum(dim=-1)                            # [B, B]
    labels = torch.arange(scores.shape[0], device=scores.device)
    logp = torch.log_softmax(scores, dim=-1)
    loss = -logp[labels, labels].mean()
    acc = (scores.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "acc": acc}


def colbert_train_step(model: ColBERT, opt_state, q_tokens, d_tokens, opt):
    """One contrastive step: the gradient of ``colbert_loss``, then
    ``opt.update`` of the model's parameters in place -> (opt_state,
    metrics)."""
    _, metrics, grads = value_and_grad(colbert_loss, model, q_tokens,
                                       d_tokens)
    return opt.update(param_groups(model), grads, opt_state), metrics
