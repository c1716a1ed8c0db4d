"""Transformer trunks (``src/repro/models/transformer.py``): the
bidirectional encoder of ColBERT and the causal LM.

Pre-norm blocks (RMSNorm or LayerNorm), a plain Python loop over the
layers in place of the reference's ``scan``. Embeddings and the
residual stream are in the compute dtype. The reference's sharding
annotations sit at their places (``constrain``, a no-op without a mesh
context): the embedded input and each layer boundary of ``forward`` as
``batch, seq, dmodel``, the logits as ``vocab``, the prefill cache's
sequence axis as ``cacheseq``.

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
a module's state and ``params_to_jax`` a state back into the tree.

A MoE trunk (``cfg.moe``) holds ``cfg.first_dense_layers`` dense blocks
(``layers``, the reference's ``dense_layers`` stack) and then the MoE
blocks (``moe_layers``), whose feed-forward is ``models/moe.py``'s; the
kv cache holds the dense layers first. ``forward``, ``lm_loss``,
``prefill`` and ``decode_step`` take ``moe_impl`` ("capacity", the
reference's default; "dense"; "ep"); a decode step routes its B new
tokens under the same capacity rule (C from T = B). ``lm_loss`` adds the
blocks' summed router loss to the cross entropy.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (Attention, attention_decode,
                                          attention_forward)
from repro_torch.models.layers import Dense, Embed, dt, gather_fsdp, norm
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.sharding.api import constrain, current_ctx
from repro_torch.train.params import from_tree, group, to_tree


class Block(nn.Module):
    """A pre-norm block: attention, then the dense MLP or (``is_moe``)
    the MoE feed-forward."""

    def __init__(self, cfg, device=None, dtype=torch.float32,
                 is_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.is_moe = is_moe
        self.attn_norm = norm(cfg.norm, cfg.d_model, cfg.norm_eps, device,
                              dtype)
        self.attn = Attention(cfg, device, dtype)
        self.mlp_norm = norm(cfg.norm, cfg.d_model, cfg.norm_eps, device,
                             dtype)
        if is_moe:
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, cfg.gated_mlp,
                           device, dtype)

    def _ffn(self, x, cfg, moe_impl: str):
        """-> (x + the feed-forward of its norm, the router loss or None)."""
        h = self.mlp_norm(x)
        if self.is_moe:
            h, aux = moe_apply(self.moe, h, cfg, impl=moe_impl)
            return x + h, aux
        return x + self.mlp(h), None

    def forward(self, x, pad_mask=None, positions=None, cfg=None,
                return_kv: bool = False, moe_impl: str = "capacity"):
        """-> (x, router loss or None), and (k, v) with ``return_kv``."""
        cfg = cfg or self.cfg
        h = attention_forward(self.attn, self.attn_norm(x), cfg,
                              positions=positions, pad_mask=pad_mask,
                              return_kv=return_kv)
        if return_kv:
            h, kv = h
        x, aux = self._ffn(x + h, cfg, moe_impl)
        return (x, aux, kv) if return_kv else (x, aux)

    def decode(self, x, cache_k, cache_v, pos: int, cfg=None,
               moe_impl: str = "capacity"):
        cfg = cfg or self.cfg
        h, _, _ = attention_decode(self.attn, self.attn_norm(x), cfg,
                                   cache_k, cache_v, pos)
        return self._ffn(x + h, cfg, moe_impl)[0]


class Transformer(nn.Module):
    """Embedding, blocks and final norm; ``forward`` gives hidden states."""

    def __init__(self, cfg, device=None):
        super().__init__()
        pdt = dt(cfg.param_dtype)
        n_moe = max(cfg.n_layers - cfg.first_dense_layers, 0) if cfg.moe else 0
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device, pdt)
        self.pos_embed = (Embed(cfg.max_seq_len, cfg.d_model, device, pdt)
                          if cfg.pos_emb == "learned" else None)
        self.layers = nn.ModuleList(Block(cfg, device, pdt)
                                    for _ in range(cfg.n_layers - n_moe))
        self.moe_layers = nn.ModuleList(Block(cfg, device, pdt, is_moe=True)
                                        for _ in range(n_moe))
        self.final_norm = norm(cfg.norm, cfg.d_model, cfg.norm_eps, device,
                               pdt)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def blocks(self):
        """Every block in order: the dense ones, then the MoE ones."""
        return list(self.layers) + list(self.moe_layers)

    def _embed(self, tokens, positions, cfg):
        cdt = dt(cfg.dtype)
        x = self.embed(tokens, cdt)
        if self.pos_embed is not None:
            x = x + self.pos_embed(positions, cdt)
        return constrain(x, "batch", "seq", "dmodel")

    def forward(self, tokens: torch.Tensor, pad_mask: torch.Tensor = None,
                cfg=None, moe_impl: str = "capacity",
                return_aux: bool = False):
        """tokens [B, S] -> hidden [B, S, d_model] in the compute dtype,
        and with ``return_aux`` the MoE blocks' summed router loss (f32;
        0 on a dense trunk). Under autograd with ``cfg.remat`` each block
        is recomputed in the backward pass (``torch.utils.checkpoint``),
        so only the blocks' inputs are kept: the reference's
        ``jax.checkpoint`` of its scanned block."""
        cfg = cfg or self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed(tokens, positions, cfg)
        aux = torch.zeros((), device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.blocks:
            if remat:
                x, a = checkpoint(layer, x, pad_mask, positions, cfg, False,
                                  moe_impl, use_reentrant=False)
            else:
                x, a = layer(x, pad_mask, positions, cfg, moe_impl=moe_impl)
            # the layer boundary (the reference's ``x + h`` in ``_block``)
            x = constrain(x, "batch", "seq", "dmodel")
            if a is not None:
                aux = aux + a
        x = self.final_norm(x)
        return (x, aux) if return_aux else x

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

    def head_weight(self) -> torch.Tensor:
        """The LM head's weight [d_model, V] in the param dtype (the
        embedding table's transpose when tied); over a mesh its FSDP
        shards gathered (``gather_fsdp``), so a loss over sequence
        chunks gathers it once."""
        if self.lm_head is None:
            return gather_fsdp(self.embed.table).T
        return gather_fsdp(self.lm_head.w)

    def logits_head(self, hidden: torch.Tensor,
                    w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden [..., d_model] -> logits [..., V] in hidden's dtype;
        ``w`` the ``head_weight`` if the caller holds it."""
        w = self.head_weight() if w is None else w
        return constrain(hidden @ w.to(hidden.dtype), "batch", "seq", "vocab")

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   cfg=None) -> Dict[str, torch.Tensor]:
        cfg = cfg or self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        dtype = dtype or dt(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                cfg=None, moe_impl: str = "capacity"):
        """tokens [B, S] -> (hidden [B, S, d_model], cache of length
        ``max_len`` (default S) holding the prompt's k and v)."""
        cfg = cfg or self.cfg
        B, S = tokens.shape
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len {max_len} < prompt length {S}")
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(tokens, positions, cfg)
        # under a mesh the cache is each layer's annotated k and v,
        # stacked (the reference's scan outputs); else written in place
        stacked = current_ctx() is not None
        cache = ({"k": [], "v": []} if stacked
                 else self.init_cache(B, max_len, cfg=cfg))
        for i, layer in enumerate(self.blocks):
            x, _, (k, v) = layer(x, None, positions, cfg, return_kv=True,
                                 moe_impl=moe_impl)
            if stacked and max_len > S:
                pad = (0, 0, 0, 0, 0, max_len - S)
                k, v = F.pad(k, pad), F.pad(v, pad)
            k = constrain(k, "batch", "cacheseq", "kv", None)
            v = constrain(v, "batch", "cacheseq", "kv", None)
            if stacked:
                cache["k"].append(k.to(dt(cfg.dtype)))
                cache["v"].append(v.to(dt(cfg.dtype)))
            else:
                cache["k"][i, :, :S] = k
                cache["v"][i, :, :S] = v
        if stacked:
            cache = {n: torch.stack(t) for n, t in cache.items()}
        return self.final_norm(x), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache, pos: int, cfg=None,
                    moe_impl: str = "capacity"):
        """token [B, 1]; cache from ``prefill`` / ``init_cache``; ``pos``
        the number of valid cache entries -> (logits [B, 1, V], cache with
        the token's k and v written at ``pos``)."""
        cfg = cfg or self.cfg
        pos = int(pos)
        x = self._embed(token, torch.full((1,), pos, device=token.device),
                        cfg)
        for i, layer in enumerate(self.blocks):
            x = layer.decode(x, cache["k"][i], cache["v"][i], pos, cfg,
                             moe_impl)
        return self.logits_head(self.final_norm(x)), cache


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor, cfg=None, loss_mask=None,
            moe_impl: str = "capacity"):
    """Causal-LM cross entropy (``src/repro/models/transformer.py``
    ``lm_loss``); tokens and labels [B, S], labels pre-shifted ->
    (xent + aux, {"xent", "aux", "tokens"}).

    The head and the f32 cross entropy run over ``cfg.logits_chunk``
    slices of the sequence, each recomputed in the backward pass under
    autograd, so the [B, S, V] logits never live at once: at most one
    chunk's. ``aux`` is the MoE blocks' summed router loss (0 on a
    dense trunk)."""
    cfg = cfg or model.cfg
    hidden, aux = model(tokens, cfg=cfg, moe_impl=moe_impl, return_aux=True)
    B, S, _ = hidden.shape
    chunk = min(cfg.logits_chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of logits_chunk "
                         f"{chunk}")
    labels = labels.long()
    mask = (torch.ones(labels.shape, device=hidden.device)
            if loss_mask is None else loss_mask.float())

    def chunk_nll(h, w, lab, msk):
        return (_nll(model.logits_head(h, w).float(), lab) * msk).sum()

    w = model.head_weight()
    tot = torch.zeros((), device=hidden.device)
    for lo in range(0, S, chunk):
        args = (hidden[:, lo:lo + chunk], w, labels[:, lo:lo + chunk],
                mask[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(chunk_nll, *args, use_reentrant=False)
        else:
            tot = tot + chunk_nll(*args)
    cnt = mask.sum()
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux, {"xent": loss, "aux": aux, "tokens": cnt}


def _nll(lg: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """-log softmax(lg)[lab] over the last axis: lg [..., V] f32, lab
    [...]. Logits laid out over the mesh with the vocab sharded (the
    ``vocab`` annotation) take the vocab-parallel form (``_sharded_nll``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(lg, DTensor) and any(p.is_shard(lg.ndim - 1)
                                       for p in lg.placements):
        return _sharded_nll(lg, lab)
    gold = torch.gather(lg, -1, lab[..., None])[..., 0]
    return torch.logsumexp(lg, dim=-1) - gold


def _sharded_nll(lg, lab):
    """Megatron's vocab-parallel cross entropy on one rank: the max, the
    sum of exponentials and the gold logit of its own vocab shard, each
    reduced over the mesh dims that shard the vocab (one all-reduce of
    [..] rows each); the logits are never gathered. -> the nll, laid out
    as ``lg`` without its vocab axis (sharded over the batch's mesh
    dims, replicated over the vocab's)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.sharding.api import from_local, lay_out
    mesh, place, v = lg.device_mesh, lg.placements, lg.ndim - 1
    out = [Replicate() if p.is_shard(v) else p for p in place]
    shape = lg.shape[:-1]

    def reduce(t, op):
        part = [Partial(op) if p.is_shard(v) else p for p in place]
        return from_local(t, mesh, part, shape, grad_placements=out
                          ).redistribute(mesh, out).to_local()

    local = lg.to_local()
    _, off = compute_local_shape_and_global_offset(lg.shape, mesh, place)
    z = local - reduce(local.detach().amax(dim=-1), "max")[..., None]
    sumexp = reduce(torch.exp(z).sum(dim=-1), "sum")
    idx = lay_out(lab, mesh, out).to_local().long() - off[v]
    ok = (idx >= 0) & (idx < local.shape[-1])
    gold = torch.gather(z, -1, idx.clamp(0, local.shape[-1] - 1)[..., None]
                        )[..., 0] * ok
    return from_local(torch.log(sumexp) - reduce(gold, "sum"), mesh, out,
                      shape)


def init_transformer(cfg, generator: Optional[torch.Generator] = None, *,
                     seed: int = 0, device: DeviceLike = None
                     ) -> TransformerLM:
    """Random weights with the reference initializers' laws: embeddings
    truncated-normal(0.02), dense weights normal(1/sqrt(d_in)), zero
    biases, unit norms. ``generator`` (on the model's device) defaults
    to one seeded with ``seed``."""
    model = TransformerLM(cfg, device)
    if model.device.type == "meta":     # shapes only: nothing to draw
        return model
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Dense, Embed, MoE)):
            m.reset_parameters(generator)
    return model


def params_from_jax(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The reference's ``init_transformer`` tree (nested dicts of arrays;
    dense ``w`` is [d_in, d_out]; layers stacked on axis 0 under
    ``dense_layers`` and, for a MoE trunk, ``moe_layers``) -> a trunk's
    state, keys under ``prefix``, as numpy arrays. The module's names
    follow the tree's, so the map is a flattening, the stacks unstacked
    into ``layers.<i>`` and ``moe_layers.<i>``."""
    return from_tree(tree, prefix)


def params_to_jax(state, prefix: str = "") -> Dict:
    """The inverse of ``params_from_jax``: a trunk's state (the names
    under ``prefix``; tensors or arrays) -> the reference's tree of host
    arrays, ``layers.<i>`` stacked on axis 0 under ``dense_layers`` and
    ``moe_layers.<i>`` under ``moe_layers``."""
    return to_tree(group((name[len(prefix):], v) for name, v in state.items()
                         if name.startswith(prefix)))
