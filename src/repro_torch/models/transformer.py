"""Transformer trunks (``src/repro/models/transformer.py``): the
bidirectional encoder of ColBERT and the causal LM.

Pre-norm blocks (RMSNorm or LayerNorm), a plain Python loop over the
layers in place of the reference's ``scan``; no sharding constraints.
Embeddings and the residual stream are in the compute dtype.

``TransformerLM`` adds the LM head and the serving steps:

  * ``logits_head`` — the LM head (the embedding table when tied);
  * ``init_cache`` — zeroed k/v cache [L, B, S_max, KV, dh];
  * ``prefill`` — hidden states and the cache of a prompt: each layer's k
    and v after qk-norm and RoPE, in the compute dtype, zero-padded to
    ``max_len``;
  * ``decode_step`` — one token against the cache (written in place).

``lm_loss`` is the training loss (autograd through ``forward``; blocks
recomputed in backward under ``cfg.remat``).

The methods take an optional ``cfg`` that decides the attention path
(``use_flash_kernel``, ``attn_full_threshold``, ``attn_chunk``), as the
reference's functions take theirs; the module's own config is the
default and fixes the shapes. ``init_transformer`` draws seeded random
weights; ``params_from_jax`` turns the reference's parameter tree into
a module's state and ``params_to_jax`` a state back into the tree. MoE
trunks are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (Attention, attention_decode,
                                          attention_forward)
from repro_torch.models.layers import Dense, Embed, dt, norm
from repro_torch.models.mlp import MLP
from repro_torch.train.params import group, to_tree


class Block(nn.Module):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = norm(cfg.norm, cfg.d_model, cfg.norm_eps, device,
                              dtype)
        self.attn = Attention(cfg, device, dtype)
        self.mlp_norm = norm(cfg.norm, cfg.d_model, cfg.norm_eps, device,
                             dtype)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, cfg.gated_mlp,
                       device, dtype)

    def forward(self, x, pad_mask=None, positions=None, cfg=None,
                return_kv: bool = False):
        h = attention_forward(self.attn, self.attn_norm(x), cfg or self.cfg,
                              positions=positions, pad_mask=pad_mask,
                              return_kv=return_kv)
        if return_kv:
            h, kv = h
        x = x + h
        x = x + self.mlp(self.mlp_norm(x))
        return (x, kv) if return_kv else x

    def decode(self, x, cache_k, cache_v, pos: int, cfg=None):
        h, _, _ = attention_decode(self.attn, self.attn_norm(x),
                                   cfg or self.cfg, cache_k, cache_v, pos)
        x = x + h
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """Embedding, blocks and final norm; ``forward`` gives hidden states."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.moe:
            raise NotImplementedError(
                f"{cfg.name}: MoE trunks (models/moe.py) are not ported yet "
                f"(ROADMAP queue 1)")
        pdt = dt(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device, pdt)
        self.pos_embed = (Embed(cfg.max_seq_len, cfg.d_model, device, pdt)
                          if cfg.pos_emb == "learned" else None)
        self.layers = nn.ModuleList(Block(cfg, device, pdt)
                                    for _ in range(cfg.n_layers))
        self.final_norm = norm(cfg.norm, cfg.d_model, cfg.norm_eps, device,
                               pdt)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _embed(self, tokens, positions, cfg):
        cdt = dt(cfg.dtype)
        x = self.embed(tokens, cdt)
        if self.pos_embed is not None:
            x = x + self.pos_embed(positions, cdt)
        return x

    def forward(self, tokens: torch.Tensor, pad_mask: torch.Tensor = None,
                cfg=None) -> torch.Tensor:
        """tokens [B, S] -> hidden [B, S, d_model] in the compute dtype.
        Under autograd with ``cfg.remat`` each block is recomputed in the
        backward pass (``torch.utils.checkpoint``), so only the blocks'
        inputs are kept: the reference's ``jax.checkpoint`` of its
        scanned block."""
        cfg = cfg or self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed(tokens, positions, cfg)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, pad_mask, positions, cfg,
                               use_reentrant=False)
            else:
                x = layer(x, pad_mask, positions, cfg)
        return self.final_norm(x)

    def load_params(self, state: Dict[str, np.ndarray]) -> "Transformer":
        """Load a ``params_from_jax`` state (numpy arrays) in place."""
        self.load_state_dict({k: torch.as_tensor(np.array(v))
                              for k, v in state.items()}, strict=True)
        return self


class TransformerLM(Transformer):
    """The causal LM: trunk, LM head, kv cache, prefill and decode."""

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__(cfg, resolve_device(device))
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab_size, False,
                              self.device, dt(cfg.param_dtype)))

    def logits_head(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.embed.table.to(hidden.dtype).T
        return self.lm_head(hidden)

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   cfg=None) -> Dict[str, torch.Tensor]:
        cfg = cfg or self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        dtype = dtype or dt(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                cfg=None):
        """tokens [B, S] -> (hidden [B, S, d_model], cache of length
        ``max_len`` (default S) holding the prompt's k and v)."""
        cfg = cfg or self.cfg
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} < prompt length {S}")
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions, cfg)
        cache = self.init_cache(B, max_len, cfg=cfg)
        for i, layer in enumerate(self.layers):
            x, (k, v) = layer(x, None, positions, cfg, return_kv=True)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        return self.final_norm(x), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache, pos: int, cfg=None):
        """token [B, 1]; cache from ``prefill`` / ``init_cache``; ``pos``
        the number of valid cache entries -> (logits [B, 1, V], cache with
        the token's k and v written at ``pos``)."""
        cfg = cfg or self.cfg
        pos = int(pos)
        x = self._embed(token, torch.full((1,), pos, device=token.device),
                        cfg)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cache["k"][i], cache["v"][i], pos, cfg)
        return self.logits_head(self.final_norm(x)), cache


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor, cfg=None, loss_mask=None):
    """Causal-LM cross entropy (``src/repro/models/transformer.py``
    ``lm_loss``); tokens and labels [B, S], labels pre-shifted ->
    (loss + aux, {"xent", "aux", "tokens"}).

    The head and the f32 cross entropy run over ``cfg.logits_chunk``
    slices of the sequence, each recomputed in the backward pass under
    autograd, so the [B, S, V] logits never live at once: at most one
    chunk's. ``aux`` (the MoE router loss) is 0 on a dense trunk."""
    cfg = cfg or model.cfg
    hidden = model(tokens, cfg=cfg)
    B, S, _ = hidden.shape
    chunk = min(cfg.logits_chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of logits_chunk "
                         f"{chunk}")
    labels = labels.long()
    mask = (torch.ones(labels.shape, device=hidden.device)
            if loss_mask is None else loss_mask.float())

    def chunk_nll(h, lab, msk):
        lg = model.logits_head(h).float()
        gold = torch.gather(lg, -1, lab[..., None])[..., 0]
        return ((torch.logsumexp(lg, dim=-1) - gold) * msk).sum()

    tot = torch.zeros((), device=hidden.device)
    for lo in range(0, S, chunk):
        args = (hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk],
                mask[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(chunk_nll, *args, use_reentrant=False)
        else:
            tot = tot + chunk_nll(*args)
    cnt = mask.sum()
    loss = tot / torch.clamp(cnt, min=1.0)
    aux = torch.zeros((), device=hidden.device)
    return loss + aux, {"xent": loss, "aux": aux, "tokens": cnt}


def init_transformer(cfg, generator: Optional[torch.Generator] = None, *,
                     seed: int = 0, device: DeviceLike = None
                     ) -> TransformerLM:
    """Random weights with the reference initializers' laws: embeddings
    truncated-normal(0.02), dense weights normal(1/sqrt(d_in)), zero
    biases, unit norms. ``generator`` (on the model's device) defaults
    to one seeded with ``seed``."""
    model = TransformerLM(cfg, device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Dense, Embed)):
            m.reset_parameters(generator)
    return model


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray],
             index: Optional[int] = None) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", out, index)
        else:
            a = np.asarray(val)
            out[prefix + key] = a if index is None else a[index]


def params_from_jax(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The reference's ``init_transformer`` tree (nested dicts of arrays;
    dense ``w`` is [d_in, d_out]; layers stacked on axis 0 under
    ``dense_layers``) -> a trunk's state, keys under ``prefix``, as numpy
    arrays. The module's names follow the tree's, so the map is a
    flattening, ``dense_layers`` unstacked into ``layers.<i>``."""
    if "moe_layers" in tree:
        raise NotImplementedError("MoE trunks (models/moe.py) are not ported "
                                  "yet (ROADMAP queue 1)")
    state: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "dense_layers":
            n = np.asarray(sub["attn_norm"]["scale"]).shape[0]
            for i in range(n):
                _flatten(sub, f"{prefix}layers.{i}.", state, i)
        else:
            _flatten(sub, f"{prefix}{key}.", state)
    return state


def params_to_jax(state, prefix: str = "") -> Dict:
    """The inverse of ``params_from_jax``: a trunk's state (the names
    under ``prefix``; tensors or arrays) -> the reference's tree of host
    arrays, ``layers.<i>`` stacked on axis 0 under ``dense_layers``."""
    return to_tree(group((name[len(prefix):], v) for name, v in state.items()
                         if name.startswith(prefix)))
