"""Attention of the trunks: GQA, RoPE, qk-norm, QKV bias; three paths.

Counterpart of ``src/repro/models/attention.py``:

1. ``full_attn``: materialized scores, for sequences up to
   ``cfg.attn_full_threshold``, and always with a pad mask (every
   ColBERT call takes it);
2. ``chunked_attn``: the online-softmax recurrence over kv chunks in
   plain torch, taken when S > ``attn_full_threshold`` and S is a
   multiple of ``attn_chunk``; causal, it walks query chunks and visits
   only the kv chunks at or below the diagonal;
3. the ``flash_attention`` kernel, when ``cfg.use_flash_kernel`` is set,
   the trunk is causal and there is no pad mask; k and v go in grouped,
   ``[B, KV, S, dh]``, not repeated. q, k and v go in as transposed
   views of the ``[B, S, heads, dh]`` projections and the kernel writes
   its output in ``[B, S, H, dh]`` memory, so no copy is made on the way
   in or out.

``attention_decode`` scores one new token against the kv cache with an
exact two-pass softmax, the cache kept grouped ``[B, S_max, KV, dh]``.
It writes the new token's k and v into the cache in place (the reference
returns a new cache; in place saves a copy of the cache per layer and
step).

Scores are computed in f32 from the compute-dtype q and k (the
reference's ``preferred_element_type=float32``), the softmax in f32,
and the weights cast to v's dtype for the second product. RoPE is the
split-half form with f32 angles. Query head h reads kv head
h // (n_heads // n_kv_heads).

The functions take the config that decides the path (``cfg``): a
module's own config only fixes its shapes, so one set of weights runs
through the kernel and through the plain paths.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import Dense, RMSNorm
from repro_torch.sharding.api import (constrain, from_local, lay_out,
                                      merge_last, split_last)


def _scale(dh: int) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, dh]; positions [S] -> x rotated, in x's dtype."""
    dh = x.shape[-1]
    if dh % 2:
        raise ValueError("RoPE requires an even head dim")
    ang = positions.float()[..., None] * rope_freqs(dh, theta, x.device)
    cos = torch.cos(ang)[..., None, :]                       # [S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """The projections (and qk-norm scales) of one layer; applied by
    ``attention_forward`` and ``attention_decode``."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.cfg = cfg
        self.wq = Dense(d, H * dh, cfg.qkv_bias, device, dtype)
        self.wk = Dense(d, KV * dh, cfg.qkv_bias, device, dtype)
        self.wv = Dense(d, KV * dh, cfg.qkv_bias, device, dtype)
        self.wo = Dense(H * dh, d, False, device, dtype)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, cfg.norm_eps, device, dtype)
            self.k_norm = RMSNorm(dh, cfg.norm_eps, device, dtype)


def _project_qkv(attn: Attention, x, cfg, positions, kv_names):
    """-> q [B, S, H, dh], k, v [B, S, KV, dh], qk-norm and RoPE applied.
    Under a mesh context the head views are laid out as q's annotation
    (``batch, qseq, heads``) and ``kv_names`` ask (``split_last``)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = split_last(attn.wq(x), H, "batch", "qseq", "heads", None)
    k = split_last(attn.wk(x), KV, *kv_names)
    v = split_last(attn.wv(x), KV, *kv_names)
    if cfg.qk_norm:
        q = attn.q_norm(q)
        k = attn.k_norm(k)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, dh] -> [B, S, KV * n_rep, dh], head-major: head h reads
    kv head h // n_rep."""
    if n_rep == 1:
        return k
    B, S, KV, dh = k.shape
    out = k[:, :, :, None, :].expand(B, S, KV, n_rep, dh).reshape(
        B, S, KV * n_rep, dh)
    from torch.distributed.tensor import DTensor
    if isinstance(out, DTensor):
        # k is replicated over the heads' mesh dims (``kv``): the repeat's
        # gradient comes back to that layout before it is summed per kv
        # head (a heads-sharded gradient has no [KV, n_rep] view)
        out = lay_out(out, out.device_mesh, k.placements)
    return out


# ---------------------------------------------------------------------------
# Full attention
# ---------------------------------------------------------------------------
def full_attn(q, k, v, pad_mask=None, *, causal: bool = False,
              q_offset: int = 0):
    """q [B, Sq, H, dh], k, v [B, Skv, H, dh]; pad_mask [B, Skv] True =
    valid -> [B, Sq, H, dh] in v's dtype. Fully masked rows give 0.
    ``DTensor`` inputs are attended on each rank's shards
    (``_on_shards``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _on_shards(q, k, v, pad_mask, lambda ql, kl, vl, ml, q0: (
            full_attn(ql, kl, vl, ml, causal=causal, q_offset=q0)))
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * _scale(
        q.shape[-1])
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), float("-inf"))
    if pad_mask is not None:
        s = s.masked_fill(~pad_mask[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.where(torch.isnan(w), torch.zeros((), device=w.device), w)
    return torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention
# ---------------------------------------------------------------------------
def _attn_over_kv_chunks(qc, k, v, *, n_chunks: int, chunk: int,
                         causal: bool, q_start: int):
    """Online softmax over kv chunks for one query chunk.
    qc [B, Cq, H, dh]; k, v [B, n_chunks * chunk, H, dh] -> [B, Cq, H, dh]."""
    B, Cq, H, dh = qc.shape
    dev = qc.device
    scale = _scale(dh)
    neg_inf = float("-inf")
    zero = torch.zeros((), device=dev)
    m = torch.full((B, H, Cq), neg_inf, device=dev)
    l = torch.zeros((B, H, Cq), device=dev)
    acc = torch.zeros((B, H, Cq, dh), device=dev)
    qpos = q_start + torch.arange(Cq, device=dev)
    qf = qc.float()
    for ci in range(n_chunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk]
        vci = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bqhd,bshd->bhqs", qf, kci.float()) * scale
        if causal:
            kpos = ci * chunk + torch.arange(chunk, device=dev)
            s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isneginf(s), zero, p)
        alpha = torch.where(torch.isneginf(m), zero, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqs,bshd->bhqd", p.to(vci.dtype), vci)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    l = torch.where(l == 0.0, torch.ones((), device=dev), l)
    return (acc / l[..., None]).transpose(1, 2).to(qc.dtype)


def chunked_attn(q, k, v, *, causal: bool, chunk: int):
    """Exact-FLOPs chunked attention; S % chunk == 0."""
    S = q.shape[1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _on_shards(q, k, v, None, lambda ql, kl, vl, _, q0: (
            _chunked_rows(ql, kl, vl, causal=causal, chunk=chunk, q0=q0)))
    nq = S // chunk
    if not causal:
        return _attn_over_kv_chunks(q, k, v, n_chunks=nq, chunk=chunk,
                                    causal=False, q_start=0)
    outs = []
    for i in range(nq):
        end = (i + 1) * chunk
        outs.append(_attn_over_kv_chunks(
            q[:, i * chunk:end], k[:, :end], v[:, :end], n_chunks=i + 1,
            chunk=chunk, causal=True, q_start=i * chunk))
    return torch.cat(outs, dim=1)


def _chunked_rows(q, k, v, *, causal: bool, chunk: int, q0: int):
    """``chunked_attn`` of the query rows [q0, q0 + n) of a sequence (q
    [B, n, H, dh]) against its whole kv: blocks of ``chunk`` rows where
    the rows fall on chunk boundaries (else the rows as one block), each
    against the kv chunks at or below its diagonal."""
    n, S = q.shape[1], k.shape[1]
    block = chunk if q0 % chunk == 0 and n % chunk == 0 else max(n, 1)
    outs = []
    for b0 in range(0, n, block):
        g = q0 + b0
        end = min(S, -(-(g + block) // chunk) * chunk) if causal else S
        outs.append(_attn_over_kv_chunks(
            q[:, b0:b0 + block], k[:, :end], v[:, :end],
            n_chunks=end // chunk, chunk=chunk, causal=causal, q_start=g))
    return (torch.cat(outs, dim=1) if outs else
            q.new_zeros(*q.shape[:-1], v.shape[-1]))


def _on_shards(q, k, v, pad_mask, attend):
    """Attention of ``DTensor`` q, k, v [B, S, H, dh] on each rank's own
    shards: (batch, head) pairs are independent, and a rank holding a
    block of query rows (``qseq`` sharded: sequence parallelism) holds
    all of kv, so ``attend(q, k, v, pad_mask, q0)`` runs on local
    tensors, q0 the global position of the rank's first query row. kv
    are laid out as q without its sequence shard, the pad mask by q's
    batch shard; kv's gradient is a partial sum over the ranks that
    split the queries. No DTensor product is dispatched, so no
    sharding rule has to fold sharded dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, place = q.device_mesh, q.placements
    if any(not (p.is_replicate() or (p.is_shard() and p.dim < 3))
           for p in place):
        raise ValueError(f"attention over q laid out {place}")
    kv_place = [Replicate() if p.is_shard(1) else p for p in place]
    grads = [Partial() if p.is_shard(1) else p for p in place]
    kl = lay_out(k, mesh, kv_place).to_local(grad_placements=grads)
    vl = lay_out(v, mesh, kv_place).to_local(grad_placements=grads)
    ml = None if pad_mask is None else lay_out(pad_mask, mesh, [
        Shard(0) if p.is_shard(0) else Replicate() for p in place]
    ).to_local()
    _, off = compute_local_shape_and_global_offset(q.shape, mesh, place)
    out = attend(q.to_local(), kl, vl, ml, off[1])
    return from_local(out, mesh, place, (*q.shape[:-1], v.shape[-1]))


# ---------------------------------------------------------------------------
# Forward (prefill / encoder) and decode
# ---------------------------------------------------------------------------
def attention_forward(attn: Attention, x, cfg, *, positions=None,
                      pad_mask=None, return_kv: bool = False):
    """x [B, S, d_model] -> y [B, S, d_model] (and the post-RoPE,
    post-qk-norm (k, v) [B, S, KV, dh] if ``return_kv``)."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    # kv heads that are not repeated take the query heads' layout; the
    # repeated ones are replicated across TP (``kv``) and the repeat is
    # laid out by the annotation below
    kv_names = ("batch", "kvseq", "heads" if cfg.q_per_kv == 1 else "kv",
                None)
    q, k, v = _project_qkv(attn, x, cfg, positions, kv_names)
    q = constrain(q, "batch", "qseq", "heads", None)
    if cfg.use_flash_kernel and pad_mask is None and cfg.causal:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True).transpose(1, 2)
    else:
        kf = constrain(_repeat_kv(k, cfg.q_per_kv),
                       "batch", "kvseq", "heads", None)
        vf = constrain(_repeat_kv(v, cfg.q_per_kv),
                       "batch", "kvseq", "heads", None)
        if (S <= cfg.attn_full_threshold or S % cfg.attn_chunk
                or pad_mask is not None):
            o = full_attn(q, kf, vf, pad_mask, causal=cfg.causal)
        else:
            o = chunked_attn(q, kf, vf, causal=cfg.causal,
                             chunk=cfg.attn_chunk)
    o = constrain(merge_last(o, "batch", "qseq", "heads"),
                  "batch", "qseq", "heads")
    y = constrain(attn.wo(o), "batch", "seq", "dmodel")
    return (y, (k, v)) if return_kv else y


def attention_decode(attn: Attention, x, cfg, cache_k, cache_v, pos: int):
    """x [B, 1, d]; cache_k, cache_v [B, S_max, KV, dh]; ``pos`` the
    number of valid cache entries, where the new token is written (in
    place). -> (y [B, 1, d], cache_k, cache_v)."""
    pos = int(pos)
    B = x.shape[0]
    KV, G, dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head
    positions = torch.full((1,), pos, device=x.device)
    q, k_new, v_new = _project_qkv(attn, x, cfg, positions,
                                   ("batch", "seq", "kv", None))
    q = q.reshape(B, 1, KV, G, dh)
    _write_token(cache_k, pos, k_new)
    _write_token(cache_v, pos, v_new)
    cache_k = constrain(cache_k, "batch", "kvseq", "kv", None)
    cache_v = constrain(cache_v, "batch", "kvseq", "kv", None)
    from torch.distributed.tensor import DTensor
    if isinstance(cache_k, DTensor):
        o = _decode_on_shards(q, cache_k, cache_v, pos)
    else:
        o = _decode_attend(q, cache_k, cache_v, pos)
    y = constrain(attn.wo(o.reshape(B, 1, cfg.n_heads * dh)),
                  "batch", "seq", "dmodel")
    return y, cache_k, cache_v


def _decode_attend(q, cache_k, cache_v, pos: int, s0: int = 0,
                   reduce=None):
    """One token's grouped attention over cache rows [s0, s0 + S): q
    [B, 1, KV, G, dh], cache_k, cache_v [B, S, KV, dh] -> o [B, 1, KV, G,
    dh]; rows past ``pos`` masked; exact two-pass softmax in f32.
    ``reduce(t, op)`` combines the row max, the exponentials' sum and
    the output across ranks holding other rows (flash-decoding)."""
    S = cache_k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(),
                     cache_k.float()) * _scale(q.shape[-1])
    valid = torch.arange(s0, s0 + S, device=q.device) <= pos
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    if reduce is not None:
        m = reduce(m, "max")
    e = torch.exp(s - m)
    e = torch.where(torch.isneginf(s), torch.zeros((), device=q.device), e)
    den = e.sum(dim=-1, keepdim=True)
    if reduce is not None:
        den = reduce(den, "sum")
    o = torch.einsum("bkgqs,bskd->bqkgd", (e / den).to(cache_v.dtype),
                     cache_v)
    return o if reduce is None else reduce(o, "sum")


def _decode_on_shards(q, cache_k, cache_v, pos: int):
    """``_decode_attend`` with the cache laid out over the mesh (its
    sequence axis sharded: ``kvseq``): each rank attends over its own
    cache rows, and the row max, sum and output are reduced over the
    mesh dims that shard them (an all-reduce of [B, KV, G] stats and of
    the [B, 1, KV, G, dh] output: the reference's partial max / sum
    all-reduces). q is laid out by the cache's batch shard."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, place = cache_k.device_mesh, cache_k.placements
    if any(p.is_shard() and p.dim > 1 for p in place):
        raise ValueError(f"decode over a cache laid out {place}")
    q_place = [Shard(0) if p.is_shard(0) else Replicate() for p in place]
    ql = lay_out(q, mesh, q_place).to_local()
    _, off = compute_local_shape_and_global_offset(cache_k.shape, mesh,
                                                   place)
    B = cache_k.shape[0]

    def reduce(t, op):
        part = [Partial(op) if p.is_shard(1) else r
                for p, r in zip(place, q_place)]
        return from_local(t, mesh, part, (B, *t.shape[1:])).redistribute(
            mesh, q_place).to_local()

    o = _decode_attend(ql, cache_k.to_local(), cache_v.to_local(), pos,
                       off[1], reduce)
    return from_local(o, mesh, q_place, (B, *o.shape[1:]))


def _write_token(cache, pos: int, new) -> None:
    """cache[:, pos] = new[:, 0], in place. A cache laid out over the
    mesh (a ``DTensor`` whose sequence axis is sharded: flash-decoding's
    layout) is written by the rank whose shard holds ``pos`` alone, in
    its local shard; ``new`` is first laid out as the cache's other
    dims are."""
    from torch.distributed.tensor import DTensor
    if not isinstance(cache, DTensor):
        cache[:, pos] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    place = [Replicate() if p.is_shard() and p.dim == 1 else p
             for p in cache.placements]
    new = lay_out(new, cache.device_mesh, place).to_local()
    local = cache.to_local()
    size, off = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    if off[1] <= pos < off[1] + size[1]:
        local[:, pos - off[1]] = new[:, 0].to(local.dtype)

