"""Masked full attention of the bidirectional encoder.

Counterpart of ``src/repro/models/attention.py`` ``_project_qkv`` and
``_full_attn`` — the path every ColBERT call takes (it always passes a
pad mask). Scores are computed in f32 from the compute-dtype q and k
(the reference's ``preferred_element_type=float32``); the softmax is in
f32; rows that come out NaN (fully masked) are set to 0; the weights are
cast to v's dtype for the second product. Written with matmul and
softmax as the reference is: the fused attention kernel belongs to the
``flash_attention`` port.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import Dense


class Attention(nn.Module):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.pos_emb != "learned" or cfg.n_kv_heads != cfg.n_heads:
            raise NotImplementedError(
                "only learned positions and full multi-head attention are "
                "ported (rope, GQA: ROADMAP queue 1)")
        d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.cfg = cfg
        self.wq = Dense(d, H * dh, cfg.qkv_bias, device, dtype)
        self.wk = Dense(d, KV * dh, cfg.qkv_bias, device, dtype)
        self.wv = Dense(d, KV * dh, cfg.qkv_bias, device, dtype)
        self.wo = Dense(H * dh, d, False, device, dtype)

    def _project_qkv(self, x):
        B, S, _ = x.shape
        c = self.cfg
        q = self.wq(x).reshape(B, S, c.n_heads, c.d_head)
        k = self.wk(x).reshape(B, S, c.n_kv_heads, c.d_head)
        v = self.wv(x).reshape(B, S, c.n_kv_heads, c.d_head)
        return q, k, v

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        q, k, v = self._project_qkv(x)
        o = full_attn(q, k, v, pad_mask)
        return self.wo(o.reshape(B, S, -1))


def full_attn(q, k, v, pad_mask):
    """q, k, v [B, S, H, dh]; pad_mask [B, Skv] True = valid
    -> [B, Sq, H, dh] in v's dtype."""
    dh = q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    s = s.masked_fill(~pad_mask[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.where(torch.isnan(w), torch.zeros((), device=w.device), w)
    return torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype), v)
