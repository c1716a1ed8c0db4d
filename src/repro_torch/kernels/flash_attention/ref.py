"""Plain PyTorch version of the flash-attention kernel
(``csrc/flash_attention.cu``).

``attention_ref`` is the reference's oracle (``kernels/flash_attention/
ref.py``): [B, H, Sq, dh] heads, an f32 softmax, NaN on a row with no
visible column. ``flash_attention_ref`` follows the contract of the TPU
kernel
``src/repro/kernels/flash_attention/kernel.py`` ``flash_attention_pallas``
(body ``_flash_kernel``), not of ``attention_ref``:

  * q [B*H, Sq, dh], k and v [B*KV, Skv, dh]; program bh reads kv row
    bh // (B*H / B*KV);
  * q is cast to f32 and scaled by f32(1/sqrt(dh)) before the product;
  * the causal diagonal is anchored bottom-right: q row i sees kv columns
    <= Skv - Sq + i;
  * the softmax is f32; masked scores are -1e30 (the kernel's NEG_INF),
    so a row with no visible column has zero mass and outputs 0
    (``attention_ref`` gives NaN there);
  * p is cast to v's dtype before the PV product, which accumulates in
    f32; the output is in q's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q [BH, Sq, dh]; k, v [BKV, Skv, dh], BH % BKV == 0 -> o [BH, Sq, dh]."""
    BH, Sq, dh = q.shape
    Skv = k.shape[1]
    group = BH // k.shape[0]
    scale = float(np.float32(1.0 / dh ** 0.5))
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.repeat_interleave(group, dim=0).float()
    s = torch.bmm(q.float() * scale, kf.transpose(1, 2))      # [BH, Sq, Skv]
    if causal:
        rows = torch.arange(Sq, device=q.device) + (Skv - Sq)
        cols = torch.arange(Skv, device=q.device)
        s = s.masked_fill(~(rows[:, None] >= cols[None, :]), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(s <= NEG_INF, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.bmm(p.to(v.dtype).float(), vf)
    return (o / torch.where(l == 0.0, torch.ones((), device=l.device), l)
            ).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool) -> torch.Tensor:
    """q [B, H, Sq, dh]; k, v [B, KV, Skv, dh], H % KV == 0 -> o
    [B, H, Sq, dh] in q's dtype (f32 softmax; the causal diagonal
    anchored bottom-right)."""
    _, H, Sq, dh = q.shape
    G = H // k.shape[1]
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        Skv = k.shape[2]
        rows = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        s = s.masked_fill(~(rows >= torch.arange(Skv, device=q.device)),
                          float("-inf"))
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vf)
    return o.to(q.dtype)
