"""Optimizers: AdamW and Adafactor with LR schedules
(``src/repro/train/optimizer.py``).

The same interface as the reference's: ``Optimizer(init, update)``,
``init(params) -> state``, ``update(params, grads, state) -> state``.
``params`` is a module or its groups (``train/params.py``: one entry per
leaf of the reference's tree, a stack as the list of its layers);
``update`` writes the new parameters in place under ``no_grad`` and
returns the new state. The state holds ``step`` (a host int) and tensors
keyed like the groups, so ``train/checkpoint.py`` writes it in the
reference's layout.

The same defaults and arithmetic, in f32: AdamW b2 = 0.95, weight decay
0.1 on every parameter, the gradients clipped to a global norm of 1.0
inside ``update``; the schedule read at ``step + 1``. Adafactor keeps a
factored second moment for every leaf of two or more dims, a stack
counting its layer axis: a stacked norm scale [L, d] is factored, and
its update clip is taken over all L layers, as the reference's is.

Over a mesh (parameters and gradients ``DTensor``s laid out alike) the
state is laid out as its parameter: AdamW's moments as the parameter,
Adafactor's factored rows and columns as its spec with the averaged dim
dropped (``sharding/params.py`` ``opt_state_specs``). The clip takes
the norm of the whole arrays; where no mesh dim of more than one rank
splits a tensor, its norm is the one-device arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.train.params import (is_dtensor, leaves, param_groups,
                                      tree_map)

_F = np.float32


# ---------------------------------------------------------------------------
# Schedules (f32, as the reference's jnp arithmetic)
# ---------------------------------------------------------------------------
def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    def lr(step) -> float:
        step = _F(step)
        warm = _F(base_lr) * step / _F(max(warmup, 1))
        prog = np.clip((step - _F(warmup)) / _F(max(total - warmup, 1)),
                       _F(0.0), _F(1.0))
        cos = _F(final_frac) + (_F(1) - _F(final_frac)) * _F(0.5) * (
            _F(1) + np.cos(_F(np.pi) * prog))
        return float(warm if step < warmup else _F(base_lr) * cos)
    return lr


def constant_schedule(base_lr: float) -> Callable:
    return lambda step: float(_F(base_lr))


# ---------------------------------------------------------------------------
# Optimizer interface
# ---------------------------------------------------------------------------
@dataclass
class Optimizer:
    init: Callable[[Any], Dict]
    update: Callable[..., Dict]    # (params, grads, state) -> state


def _split_dims(x) -> tuple:
    """The mesh dims of more than one rank that split ``x`` (a
    ``DTensor``; none for a plain tensor)."""
    if not is_dtensor(x):
        return ()
    if any(p.is_partial() for p in x.placements):
        raise ValueError("a partial sum has no norm of its own: lay it out")
    mesh = x.device_mesh
    return tuple(i for i, p in enumerate(x.placements)
                 if p.is_shard() and mesh.size(i) > 1)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (in f32), on the
    tensors' device. A ``DTensor`` counts its whole array: each rank
    takes its shard's norm, and the squares of a split tensor's shard
    norms are summed over the ranks that split it."""
    import torch.distributed as dist
    xs = leaves(tree)
    norms = list(torch._foreach_norm(
        [(x.to_local() if is_dtensor(x) else x).float() for x in xs]))
    split: Dict[tuple, list] = {}
    for i, x in enumerate(xs):
        dims = _split_dims(x)
        if dims:
            split.setdefault((id(x.device_mesh), dims), []).append(i)
    for (_, dims), idx in split.items():
        sq = torch.stack([norms[i] for i in idx]).square()
        mesh = xs[idx[0]].device_mesh
        for d in dims:
            dist.all_reduce(sq, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            norms[i] = sq[j].sqrt()
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / norm), in their own dtypes;
    the norm before the clip)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros of ``p``'s shape; a ``DTensor``'s laid out as it."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm=1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        groups = param_groups(params)
        return {"step": 0, "m": tree_map(_zeros_f32, groups),
                "v": tree_map(_zeros_f32, groups)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        b1t = float(_F(1) - _F(b1) ** _F(step))
        b2t = float(_F(1) - _F(b2) ** _F(step))
        lr_t = lr_fn(step)
        P = leaves(param_groups(params))
        G = [g.float() for g in leaves(grads)]
        M, V = leaves(state["m"]), leaves(state["v"])
        # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
        torch._foreach_mul_(M, b1)
        torch._foreach_add_(M, torch._foreach_mul(G, 1 - b1))
        gg = torch._foreach_mul(G, 1 - b2)
        torch._foreach_mul_(gg, G)
        torch._foreach_mul_(V, b2)
        torch._foreach_add_(V, gg)
        del G, gg
        # p -= lr (m / b1t / (sqrt(v / b2t) + eps) + wd p), in f32
        den = torch._foreach_div(V, b2t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        delta = torch._foreach_div(M, b1t)
        torch._foreach_div_(delta, den)
        del den
        Pf = [p.float() for p in P]
        torch._foreach_add_(delta, torch._foreach_mul(Pf, weight_decay))
        torch._foreach_mul_(delta, lr_t)
        torch._foreach_sub_(Pf, delta)
        for p, new in zip(P, Pf):
            if new is not p:
                p.copy_(new)
        return {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------
def _stacked(x):
    """A group's value as one tensor (a stack stacked on axis 0)."""
    return torch.stack(list(x)) if isinstance(x, (list, tuple)) else x


def _shape(p):
    """A group's shape, a stack's layer axis first."""
    if isinstance(p, (list, tuple)):
        return (len(p),) + tuple(p[0].shape)
    return tuple(p.shape)


def _placements(p):
    """A group's placements over its mesh, a stack's layer axis first
    (None for plain tensors)."""
    from torch.distributed.tensor import Shard
    t = leaves(p)[0]
    if not is_dtensor(t):
        return None
    off = 1 if isinstance(p, (list, tuple)) else 0
    return tuple(Shard(q.dim + off) if q.is_shard() else q
                 for q in t.placements)


def _drop(place, dim: int):
    """Placements once tensor dim ``dim`` is averaged away (its mesh
    dims replicated, later dims one lower)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if q.is_shard() and q.dim == dim
                 else Shard(q.dim - 1) if q.is_shard() and q.dim > dim
                 else q for q in place)


def _laid_as(x, like):
    """``x`` laid out as the ``DTensor`` ``like`` (a plain ``x`` as it
    is)."""
    if is_dtensor(like) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              min_dim_factored: int = 2) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def _slot(p):
        shape = _shape(p)
        t = leaves(p)[0]
        place = _placements(p)

        def z(s, pl=None):
            if place is None:
                return torch.zeros(s, dtype=torch.float32, device=t.device)
            from torch.distributed.tensor import zeros
            return zeros(s, dtype=torch.float32, device_mesh=t.device_mesh,
                         placements=pl)

        n = len(shape)
        if n >= min_dim_factored:
            return {"vr": z(shape[:-1], place and _drop(place, n - 1)),
                    "vc": z(shape[:-2] + shape[-1:],
                            place and _drop(place, n - 2))}
        return {"v": z(shape, place)}

    def init(params):
        groups = param_groups(params)
        return {"step": 0, "slots": {k: _slot(v) for k, v in groups.items()}}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        beta2 = float(_F(1) - _F(step) ** _F(-decay))
        lr_t = lr_fn(step)
        groups = param_groups(params)
        for path, p in groups.items():
            slot = state["slots"][path]
            g = _stacked(grads[path]).float()
            g2 = g * g + eps
            if "vr" in slot:
                vr = _laid_as(beta2 * slot["vr"]
                              + (1 - beta2) * g2.mean(-1), slot["vr"])
                vc = _laid_as(beta2 * slot["vc"]
                              + (1 - beta2) * g2.mean(-2), slot["vc"])
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                u = (g * torch.rsqrt(vr / denom)[..., None]
                     * torch.rsqrt(vc)[..., None, :])
                slot["vr"], slot["vc"] = vr, vc
            else:
                v = _laid_as(beta2 * slot["v"] + (1 - beta2) * g2,
                             slot["v"])
                u = g * torch.rsqrt(v)
                slot["v"] = v
            # update clipping (RMS(u) <= clip_threshold)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = _stacked(p).float()
            new = _laid_as(pf - (lr_t * u + weight_decay * lr_t * pf), pf)
            if isinstance(p, (list, tuple)):
                for i, t in enumerate(p):
                    t.copy_(new[i])
            else:
                p.copy_(new)
        return {"step": step, "slots": state["slots"]}

    return Optimizer(init=init, update=update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(name)


def optimizer_state_bytes(params, name: str) -> int:
    """Optimizer memory from the groups' shapes (a stack counted as the
    reference's stacked leaf)."""
    total = 0
    for p in param_groups(params).values():
        shape = _shape(p)
        n = int(np.prod(shape))
        if name == "adamw":
            total += 2 * n * 4
        elif len(shape) >= 2:
            total += (int(np.prod(shape[:-1]))
                      + int(np.prod(shape[:-2] + shape[-1:]))) * 4
        else:
            total += n * 4
    return total
