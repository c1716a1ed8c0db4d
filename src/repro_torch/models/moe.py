"""Mixture-of-Experts FFN with top-k routing (``src/repro/models/moe.py``).

Three execution paths, the reference's:

* ``moe_dense``    — every expert runs on every token, combined with the
                     sparsified router weights. Exact, O(E) compute: the
                     oracle the capacity path is held to (capacity -> inf)
                     and the smoke path of ``launch/train.py``.
* ``moe_capacity`` — GShard / Switch capacity dispatch: each assignment's
                     slot in its expert from a stable sort
                     (``_positions_in_expert``), the kept ones copied into
                     an [E * C, d] buffer, batched expert ``bmm``, then a
                     gather back weighted by the router. Assignments past
                     an expert's capacity C are dropped (their expert
                     output is zero; the residual stream still carries
                     the token).
* ``moe_ep``       — the reference's expert-parallel all-to-all; here the
                     capacity path (see its docstring).

Every step gives the same bits on every run, on the card too: the
router's top-k is a stable sort (ties to the lower expert id, as
``lax.top_k``); the dispatch writes each live slot once into a buffer
with one sink row for the dropped assignments (no ``index_add_``, whose
atomics add in a changing order); a token's k copies are an ``expand``,
whose backward sums over k in one order; the gather back is
``F.embedding``, whose backward sums rows by sorting.

Weights keep the reference's layout: ``router.w`` [d, E] (f32 whatever
the param dtype), ``w1`` / ``w3`` [E, d, f], ``w2`` [E, f, d], and the
shared experts as dense ``shared_w1`` / ``shared_w3`` [d, f * n_shared],
``shared_w2`` [f * n_shared, d]. Activations run in the input's dtype,
the weights cast to it per call, as the reference's ``astype``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, act_fn


class MoE(nn.Module):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = Dense(d, E, False, device, torch.float32)

        def experts(*shape):
            return nn.Parameter(torch.empty(E, *shape, device=device,
                                            dtype=dtype))
        self.w1 = experts(d, f)
        self.w2 = experts(f, d)
        self.w3 = experts(d, f) if cfg.gated_mlp else None
        self.shared_w1 = self.shared_w2 = self.shared_w3 = None
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.shared_w1 = Dense(d, fs, False, device, dtype)
            self.shared_w2 = Dense(fs, d, False, device, dtype)
            if cfg.gated_mlp:
                self.shared_w3 = Dense(d, fs, False, device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The experts' weights normal(0, 1/sqrt(d_in)), ``init_moe``'s
        law (the router and shared experts are ``Dense``: their own)."""
        with torch.no_grad():
            for w in (self.w1, self.w2, self.w3):
                if w is not None:
                    w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]),
                              generator=generator)


def capacity_for(n_tokens: int, cfg) -> int:
    """The reference's default capacity: max(8, round(T k / E * factor)),
    Python's ``round`` (half to even)."""
    return int(max(8, round(n_tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def _router(p: MoE, x2d: torch.Tensor, cfg):
    """x2d [T, d] -> (weights [T, k] f32, ids [T, k] int64, aux scalar).

    f32 logits and softmax; the top k by a stable descending sort (ties
    to the lower expert id); the k weights renormalised; the Switch
    load-balance loss E * sum(mean prob * mean count) * coefficient."""
    probs = torch.softmax(x2d.float() @ p.router.w.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[:, :cfg.top_k], order[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    E = cfg.n_experts
    me = probs.mean(dim=0)
    ce = torch.bincount(ids.reshape(-1), minlength=E).float() / x2d.shape[0]
    aux = E * torch.sum(me * ce) * cfg.router_aux_loss
    return weights, ids, aux


def _expert_ffn(p: MoE, h: torch.Tensor, cfg) -> torch.Tensor:
    """h [E, C, d] -> [E, C, d], each expert's FFN as one batched bmm."""
    act = act_fn(cfg.act)
    a = act(torch.bmm(h, p.w1.to(h.dtype)))
    if p.w3 is not None:
        a = a * torch.bmm(h, p.w3.to(h.dtype))
    return torch.bmm(a, p.w2.to(h.dtype))


def _shared_ffn(p: MoE, x2d: torch.Tensor, cfg) -> torch.Tensor:
    h = act_fn(cfg.act)(p.shared_w1(x2d))
    if p.shared_w3 is not None:
        h = h * p.shared_w3(x2d)
    return p.shared_w2(h)


# ---------------------------------------------------------------------------
# Dense (oracle / smoke) path
# ---------------------------------------------------------------------------
def moe_dense(p: MoE, x: torch.Tensor, cfg):
    """x [B, S, d] -> (y [B, S, d], aux): every expert on every token."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    weights, ids, aux = _router(p, x2d, cfg)
    # combine weights as a dense [T, E] matrix (zero off the top-k)
    comb = torch.zeros(x2d.shape[0], cfg.n_experts, dtype=x2d.dtype,
                       device=x2d.device).scatter(1, ids,
                                                  weights.to(x2d.dtype))
    h = act_fn(cfg.act)(torch.einsum("td,edf->tef", x2d, p.w1.to(x2d.dtype)))
    if p.w3 is not None:
        h = h * torch.einsum("td,edf->tef", x2d, p.w3.to(x2d.dtype))
    y_all = torch.einsum("tef,efd->ted", h, p.w2.to(x2d.dtype))
    y = torch.einsum("ted,te->td", y_all, comb)
    if p.shared_w1 is not None:
        y = y + _shared_ffn(p, x2d, cfg)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Capacity (production) path
# ---------------------------------------------------------------------------
def _positions_in_expert(ids_flat: torch.Tensor, n_experts: int
                         ) -> torch.Tensor:
    """pos[i] = |{j < i : ids[j] == ids[i]}| by a stable sort and a
    running max of each run's start (the reference's
    ``associative_scan``), not a [N, E] one-hot cumsum."""
    N = ids_flat.shape[0]
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    idx = torch.arange(N, device=ids_flat.device)
    is_start = torch.ones(N, dtype=torch.bool, device=ids_flat.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = torch.empty_like(idx)
    pos[order] = idx - seg_start
    return pos


def dispatch(ids: torch.Tensor, n_experts: int, capacity: int):
    """ids [T, k] -> (keep [T * k] bool, slot [T * k] int64): assignment
    i (token-major, ``ids.reshape(-1)``'s order) goes to slot
    ids * C + pos of the [E * C] buffer if its position in its expert is
    under C, else to the sink slot E * C."""
    ids_flat = ids.reshape(-1)
    pos = _positions_in_expert(ids_flat, n_experts)
    keep = pos < capacity
    slot = torch.where(keep, ids_flat * capacity + pos,
                       n_experts * capacity)
    return keep, slot


def moe_capacity(p: MoE, x: torch.Tensor, cfg, capacity: int = None):
    """x [B, S, d] -> (y, aux): capacity dispatch, the default capacity
    ``capacity_for(B * S, cfg)``; assignments over it are dropped."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    x2d = x.reshape(T, d)
    weights, ids, aux = _router(p, x2d, cfg)
    C = capacity_for(T, cfg) if capacity is None else int(capacity)
    keep, slot = dispatch(ids, E, C)

    # each live slot written once; the dropped go to the sink row E * C
    x_assign = x2d[:, None].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros(E * C + 1, d, dtype=x2d.dtype, device=x2d.device)
    buf = buf.index_put((slot,), x_assign)
    out = _expert_ffn(p, buf[:E * C].view(E, C, d), cfg).reshape(E * C, d)

    # gather back per assignment (the sink row reads zeros), weight,
    # combine over the k slots
    out = torch.cat([out, out.new_zeros(1, d)])
    w = (weights.reshape(-1) * keep).to(out.dtype)
    y = (F.embedding(slot, out) * w[:, None]).reshape(T, k, d).sum(dim=1)
    if p.shared_w1 is not None:
        y = y + _shared_ffn(p, x2d, cfg)
    return y.reshape(B, S, d), aux


def moe_ep(p: MoE, x: torch.Tensor, cfg, capacity: int = None):
    """The reference's expert-parallel path routes tokens to the expert's
    owner with an all-to-all over a mesh's ``model`` axis, and takes the
    capacity path when there is no such mesh. The port has no mesh until
    the sharding slice (ROADMAP queue 1): without a process group of
    several ranks it takes the capacity path, as the reference does with
    no mesh; with one it raises."""
    import torch.distributed as dist
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise NotImplementedError(
            "moe_ep's all-to-all across ranks waits for the sharding "
            "slice (ROADMAP queue 1)")
    return moe_capacity(p, x, cfg, capacity)


def moe_apply(p: MoE, x: torch.Tensor, cfg, impl: str = "capacity"):
    if impl == "dense":
        return moe_dense(p, x, cfg)
    if impl == "ep":
        return moe_ep(p, x, cfg)
    return moe_capacity(p, x, cfg)
