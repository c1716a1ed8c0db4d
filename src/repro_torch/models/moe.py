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
                     the token). Over a mesh every rank dispatches every
                     token (the reference's global buffer) and runs the
                     experts its ``experts`` annotation gives it.
* ``moe_ep``       — expert parallel: under a mesh context whose mesh has
                     a ``model`` axis, each rank runs its E / n_shards
                     experts and tokens go to their expert's owner and
                     back by all-to-all (see its docstring); the
                     capacity path otherwise.

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

from repro_torch.models.layers import Dense, act_fn, gather_fsdp
from repro_torch.sharding.api import constrain, from_local, lay_out


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


def _top_k(probs: torch.Tensor, k: int):
    """The top k of each row by a stable descending sort (ties to the
    lower expert id), the k weights renormalised -> (weights, ids)."""
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[:, :k], order[:, :k]
    return weights / weights.sum(dim=-1, keepdim=True), ids


def _load_means(probs: torch.Tensor, ids: torch.Tensor, E: int):
    """(mean router probability, mean assignment count) per expert. The
    counts are an integer ``scatter_add_`` (``bincount``'s counts on every
    device, and it has a ``meta`` kernel for the dry run)."""
    flat = ids.reshape(-1)
    counts = flat.new_zeros(E, dtype=torch.long).scatter_add_(
        0, flat, torch.ones_like(flat))
    ce = counts.float() / probs.shape[0]
    return probs.mean(dim=0), ce


def _router(p: MoE, x2d: torch.Tensor, cfg):
    """x2d [T, d] -> (weights [T, k] f32, ids [T, k] int64, aux scalar).

    f32 logits and softmax; the top k (``_top_k``); the Switch
    load-balance loss E * sum(mean prob * mean count) * coefficient."""
    probs = torch.softmax(x2d.float() @ p.router.w.float(), dim=-1)
    weights, ids = _top_k(probs, cfg.top_k)
    E = cfg.n_experts
    me, ce = _load_means(probs, ids, E)
    aux = E * torch.sum(me * ce) * cfg.router_aux_loss
    return weights, ids, aux


def _expert_ffn(p: MoE, h: torch.Tensor, cfg) -> torch.Tensor:
    """h [E, C, d] -> [E, C, d], each expert's FFN as one batched bmm;
    the products annotated ``experts`` (the reference's sites)."""
    act = act_fn(cfg.act)
    w1, w2, w3 = (None if w is None else gather_fsdp(w.to(h.dtype))
                  for w in (p.w1, p.w2, p.w3))
    a = act(constrain(torch.bmm(h, w1), "experts", None, None))
    if w3 is not None:
        a = a * constrain(torch.bmm(h, w3), "experts", None, None)
    return constrain(torch.bmm(a, w2), "experts", None, None)


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
    x_in = x2d = x.reshape(T, d)
    x2d = _global_tokens(x2d)
    weights, ids, aux = _router(p, x2d, cfg)
    C = capacity_for(T, cfg) if capacity is None else int(capacity)
    keep, slot = _dispatch(ids, E, C)

    # each live slot written once; the dropped go to the sink row E * C
    x_assign = x2d[:, None].expand(T, k, d).reshape(T * k, d)
    buf = x2d.new_zeros(E * C + 1, d).index_put((slot,), x_assign)
    buf = constrain(buf[:E * C].view(E, C, d), "experts", None, None)
    out = _expert_ffn(p, buf, cfg).reshape(E * C, d)

    # gather back per assignment (the sink row reads zeros), weight,
    # combine over the k slots
    out = torch.cat([out, out.new_zeros(1, d)])
    w = (weights.reshape(-1) * keep).to(out.dtype)
    y = (F.embedding(slot, out) * w[:, None]).reshape(T, k, d).sum(dim=1)
    if p.shared_w1 is not None:
        y = y + _shared_ffn(p, x_in, cfg)
    return y.reshape(B, S, d), aux


def _global_tokens(x2d: torch.Tensor) -> torch.Tensor:
    """The capacity dispatch sees every token: laid out over a mesh, the
    [T, d] tokens are gathered onto every rank (the reference's global
    [E, C, d] buffer, whose slot positions count over the whole batch);
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x2d, DTensor):
        return x2d
    mesh = x2d.device_mesh
    return lay_out(x2d, mesh, [Replicate()] * mesh.ndim)


def _dispatch(ids: torch.Tensor, n_experts: int, capacity: int):
    """``dispatch``; on replicated ``DTensor`` ids (``_global_tokens``)
    the same index arithmetic on the local copy, every rank's the same,
    returned replicated."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ids, DTensor):
        return dispatch(ids, n_experts, capacity)
    mesh, place = ids.device_mesh, ids.placements
    return tuple(from_local(t, mesh, place, t.shape)
                 for t in dispatch(ids.to_local(), n_experts, capacity))


# ---------------------------------------------------------------------------
# Expert-parallel (EP) path: all-to-all token routing over the model axis
# ---------------------------------------------------------------------------
def ep_capacities(n_local: int, n_data: int, n_shards: int, cfg,
                  capacity: int = None):
    """(cap_send, C_loc), the reference's: slots a (sender, owner) lane
    carries, ``capacity`` or max(8, round(T_loc k / n_shards * factor));
    slots an expert holds on its owner, max(8, round(T_loc n_data k / E
    * factor)); Python's ``round`` (half to even)."""
    k, f = cfg.top_k, cfg.capacity_factor
    cap_send = capacity or int(max(8, round(n_local * k / n_shards * f)))
    C_loc = int(max(8, round(n_local * n_data * k / cfg.n_experts * f)))
    return int(cap_send), C_loc


def _local(w: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The part of ``w`` this rank computes with, laid out by ``spec``.
    A ``DTensor`` is redistributed to ``spec`` (an all-gather of what
    ``spec`` leaves whole) and its local tensor taken, its gradient
    summed back over the ranks that share it (a partial sum there). A
    plain tensor, the whole weight on every rank, is narrowed to this
    rank's slice of each dim ``spec`` names (one axis a dim)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.launch.mesh import axis_size
    from repro_torch.sharding.api import placements
    target = placements(spec, mesh)
    if isinstance(w, DTensor):
        grads = [Partial() if isinstance(t, Replicate) else t for t in target]
        return w.redistribute(mesh, target).to_local(grad_placements=grads)
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = axis_size(mesh, axis)
            w = w.chunk(n, dim)[mesh.get_local_rank(axis)]
    return w


def _mesh_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over every rank of ``mesh`` (an all-reduce over
    each of its axes in turn), with a gradient."""
    for axis in mesh.mesh_dim_names:
        t = _AllReduce.apply(t, mesh.get_group(axis))
    return t / mesh.size()


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` in equal chunks along dim 0;
    its backward is the all-to-all back."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.detach().contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


class _AllReduce(torch.autograd.Function):
    """The sum over ``group`` on every rank; the gradient likewise summed
    (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = t.detach().contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _FromFirst(torch.autograd.Function):
    """The tensor of the group's first rank, on every rank of the group;
    the gradient summed back onto the first rank's (zero elsewhere)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = t.detach().contiguous().clone()
        dist.broadcast(out, dist.get_global_rank(group, 0), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.reduce(g, dist.get_global_rank(ctx.group, 0), group=ctx.group)
        if dist.get_rank(ctx.group) != 0:
            g.zero_()
        return g, None


def moe_ep(p: MoE, x: torch.Tensor, cfg, capacity: int = None, *,
           stats: dict = None):
    """Expert-parallel MoE: each token's assignments are ROUTED to the
    rank that owns their expert by an all-to-all over the mesh's
    ``model`` axis, run there, and routed back; the capacity path
    (``moe_capacity``) when no mesh context is active or its mesh has no
    ``model`` axis. A ``model`` axis of one rank takes this path too,
    with its own capacities (``ep_capacities``), as the reference does.

    ``x`` [B_loc, S, d] is this rank's rows (the reference's shard of
    the batch over the data axes; ranks along ``model`` hold the same
    rows, and each routes its own copy); y [B_loc, S, d] is the first
    model rank's result on every rank of the axis, so the ranks' copies
    stay equal where a later copy's assignments overflow ``C_loc`` (the
    reference's output, replicated over ``model``, is that rank's too).
    The experts' ``w1`` / ``w2`` / ``w3`` are DTensors laid out
    ``(model, fsdp, None)`` / ``(model, None, fsdp)``
    (``sharding.params.distribute_params``; the
    FSDP slice is all-gathered over the data axes here) or the whole
    weights on every rank (each rank takes its E / n_shards experts);
    the router and shared experts likewise, used whole. ``aux`` is the
    load-balance loss of the means over every rank.

    A rank sends [n_shards, cap_send] slots (assignments past a lane's
    ``cap_send`` dropped), receives the slots meant for its experts,
    dispatches them into [E_loc, C_loc] (past ``C_loc`` dropped), runs
    its experts, and returns each slot's output to its sender. Gradients
    flow through both exchanges (``_AllToAll``, whose backward is the
    all-to-all back) and the means (``_AllReduce``): each rank's
    backward is of its own loss, summed over the ranks that share a
    weight. ``stats``, if given, receives ``cap_send``, ``C_loc`` and the
    two keep masks (``keep`` [T_loc k] of the sends, ``keep2`` of the
    received slots)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import axis_size
    from repro_torch.sharding.api import P, current_ctx

    ctx = current_ctx()
    names = tuple(getattr(ctx.mesh, "mesh_dim_names", None) or ()) \
        if ctx is not None else ()
    if "model" not in names:
        return moe_capacity(p, x, cfg, capacity)
    mesh = ctx.mesh
    data_axes = tuple(a for a in names if a != "model")
    n_shards = axis_size(mesh, "model")
    E, k = cfg.n_experts, cfg.top_k
    if E % n_shards:
        raise ValueError(f"{E} experts over {n_shards} model ranks")
    E_loc = E // n_shards
    n_data = 1
    for a in data_axes:
        n_data *= axis_size(mesh, a)
    B, S, d = x.shape
    T_loc = B * S
    cap_send, C_loc = ep_capacities(T_loc, n_data, n_shards, cfg, capacity)
    group = mesh.get_group("model")

    w1 = _local(p.w1, mesh, P("model", None, None))
    w2 = _local(p.w2, mesh, P("model", None, None))
    w3 = (_local(p.w3, mesh, P("model", None, None))
          if p.w3 is not None else None)
    x2d = x.reshape(T_loc, d)
    probs = torch.softmax(
        x2d.float() @ _local(p.router.w, mesh, P()).float(), dim=-1)
    weights, ids = _top_k(probs, k)
    me, ce = _load_means(probs, ids, E)
    aux = E * torch.sum(_mesh_mean(me, mesh) * _mesh_mean(ce, mesh)) \
        * cfg.router_aux_loss

    # send lanes: assignment i (token-major) to its owner's lane, in order
    ids_f = ids.reshape(-1)
    w_f = weights.reshape(-1).to(x2d.dtype)
    keep, slot = dispatch(ids_f // E_loc, n_shards, cap_send)
    x_assign = x2d[:, None].expand(T_loc, k, d).reshape(T_loc * k, d)
    send = torch.zeros(n_shards * cap_send + 1, d, dtype=x2d.dtype,
                       device=x2d.device).index_put((slot,), x_assign)
    send = send[:n_shards * cap_send]
    send_eid = torch.full((n_shards * cap_send + 1,), -1, dtype=torch.int64,
                          device=x2d.device)
    send_eid[slot] = ids_f % E_loc
    send_eid = send_eid[:n_shards * cap_send].contiguous()
    recv = _AllToAll.apply(send, group)
    recv_eid = torch.empty_like(send_eid)
    dist.all_to_all_single(recv_eid, send_eid, group=group)

    # the received slots into this rank's experts, [E_loc, C_loc]
    valid = recv_eid >= 0
    pos = _positions_in_expert(torch.where(valid, recv_eid, E_loc),
                               E_loc + 1)
    keep2 = valid & (pos < C_loc)
    slot2 = torch.where(keep2, recv_eid * C_loc + pos, E_loc * C_loc)
    buf = torch.zeros(E_loc * C_loc + 1, d, dtype=x2d.dtype,
                      device=x2d.device).index_put((slot2,), recv)
    h = buf[:E_loc * C_loc].view(E_loc, C_loc, d)
    a = act_fn(cfg.act)(torch.bmm(h, w1.to(h.dtype)))
    if w3 is not None:
        a = a * torch.bmm(h, w3.to(h.dtype))
    out = torch.bmm(a, w2.to(h.dtype)).reshape(E_loc * C_loc, d)
    back = F.embedding(slot2, torch.cat([out, out.new_zeros(1, d)]))

    # each slot's output back to its sender; weight, combine the k slots
    ret = _AllToAll.apply(back, group)
    ret = torch.cat([ret, ret.new_zeros(1, d)])
    y = (F.embedding(slot, ret) * (w_f * keep)[:, None]).reshape(
        T_loc, k, d).sum(dim=1)
    y = _FromFirst.apply(y.reshape(B, S, d).to(x.dtype), group)
    if p.shared_w1 is not None:
        act = act_fn(cfg.act)
        sw = [_local(m.w, mesh, P()) if m is not None else None
              for m in (p.shared_w1, p.shared_w2, p.shared_w3)]
        hs = act(x2d @ sw[0].to(x2d.dtype))
        if sw[2] is not None:
            hs = hs * (x2d @ sw[2].to(x2d.dtype))
        y = y + (hs @ sw[1].to(x2d.dtype)).reshape(B, S, d)
    if stats is not None:
        stats.update(cap_send=cap_send, C_loc=C_loc, keep=keep, keep2=keep2)
    return y, aux


def moe_apply(p: MoE, x: torch.Tensor, cfg, impl: str = "capacity"):
    if impl == "dense":
        return moe_dense(p, x, cfg)
    if impl == "ep":
        return moe_ep(p, x, cfg)
    return moe_capacity(p, x, cfg)
