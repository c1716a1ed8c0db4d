"""Bidirectional encoder trunk (``src/repro/models/transformer.py``
``forward`` over ``dense_layers``).

Pre-norm blocks, a plain Python loop over the layers in place of the
reference's ``scan``; no sharding constraints. Embeddings and the
residual stream are in the compute dtype (bf16 for ColBERTv2).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.layers import Embed, LayerNorm, dt
from repro_torch.models.mlp import MLP


class Block(nn.Module):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.norm != "layernorm":
            raise NotImplementedError(
                "only LayerNorm trunks are ported (ROADMAP queue 1)")
        self.attn_norm = LayerNorm(cfg.d_model, cfg.norm_eps, device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.mlp_norm = LayerNorm(cfg.d_model, cfg.norm_eps, device, dtype)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, cfg.gated_mlp,
                       device, dtype)

    def forward(self, x, pad_mask):
        x = x + self.attn(self.attn_norm(x), pad_mask)
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.causal:
            raise NotImplementedError(
                "causal trunks are not ported (ROADMAP queue 1)")
        pdt = dt(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device, pdt)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, device, pdt)
        self.layers = nn.ModuleList(Block(cfg, device, pdt)
                                    for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(cfg.d_model, cfg.norm_eps, device, pdt)

    def forward(self, tokens: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> hidden [B, S, d_model] in the compute dtype."""
        cdt = dt(self.cfg.dtype)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens, cdt) + self.pos_embed(pos, cdt)
        for layer in self.layers:
            x = layer(x, pad_mask)
        return self.final_norm(x)
