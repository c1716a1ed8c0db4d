"""DimeNet (Gasteiger et al., 2020 [arXiv:2003.03123])
(``src/repro/models/gnn/dimenet.py``): directional message passing with
radial (Bessel) and spherical (Bessel x Legendre) bases.

Messages live on directed edges (j -> i) and are updated from incoming
edges (k -> j) with an angular basis over the (k, j, i) triplet. The
triplet list is built on the host with ``triplet_cap`` incoming edges
per edge (padded and masked), so every step has fixed shapes.

Two task heads: ``graph`` (per-atom contributions summed per molecule,
the ``molecule`` cell) and ``node`` (per-node class logits, the citation
and sampled cells, which carry node features and a synthetic layout as
positions).

Host side, numpy as in the reference: ``spherical_bessel_roots``
(scipy's ``brentq``) and ``build_triplets`` (vectorized here; its lists
equal the reference's loop's). On tensors: the bases, ``_geometry``,
the ``DimeNet`` module (the reference's tree: ``blocks`` stacked there,
a module list here), ``dimenet_forward`` and ``dimenet_loss``.

Every reduction gives the same bits on every run, on the card too: the
gathers of node and edge rows (``hN[src]``, ``hN[dst]``, ``pre[t_in]``)
are ``F.embedding``, whose backward sums rows by sorting; the
triplet -> edge reduction is the reference's reshape and sum (``t_out``
is ``repeat(arange(E), cap)`` by construction); the edge -> node and
node -> graph sums (``segment_sum``) gather each segment's rows through
a padded CSR table and sum them in edge order
(``core/segment.py`` ``sorted_segment_sum``), never
through atomics, and with no [N, E] one-hot (3.7 TFLOP a pass at the
sampled cell's 170k nodes). The blocks run under
``torch.utils.checkpoint`` when grad is on, as the reference's
``jax.checkpoint``. Parameters stay in their param dtype and are cast
to the compute dtype per call.

The reference's nine sharding annotations sit at their places (bases
on ``edges`` / ``triplets``, node and message tensors, the triplet
products, the block's aggregate, the edge and node outputs). Over a
mesh the row gathers take each rank's own ids' rows from the table
gathered whole (``_take``), the bases are computed on each rank's rows
(``_rowwise``) and the segment sums are partial sums reduced by the
node annotation.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.segment import sorted_segment_sum
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Dense, Embed, act_fn, dt
from repro_torch.sharding.api import constrain
from repro_torch.train.params import from_tree, group, to_tree


# ---------------------------------------------------------------------------
# Basis functions
# ---------------------------------------------------------------------------
def spherical_bessel_roots(n_spherical: int, n_radial: int) -> np.ndarray:
    """Roots z_{l,n} of the spherical Bessel j_l, computed on the host."""
    return _roots(n_spherical, n_radial).copy()


@functools.lru_cache(maxsize=8)
def _roots(n_spherical: int, n_radial: int) -> np.ndarray:
    from scipy.optimize import brentq
    from scipy.special import spherical_jn
    roots = np.zeros((n_spherical, n_radial))
    for l in range(n_spherical):
        # bracket roots by scanning; j_l's n-th root is near (n + l/2) * pi
        grid = np.linspace(l + 1e-3, (n_radial + l + 2) * np.pi, 4096)
        vals = spherical_jn(l, grid)
        found = []
        for a, b, va, vb in zip(grid[:-1], grid[1:], vals[:-1], vals[1:]):
            if va * vb < 0:
                found.append(brentq(lambda x: spherical_jn(l, x), a, b))
            if len(found) == n_radial:
                break
        roots[l] = found[:n_radial]
    return roots


def envelope(x: torch.Tensor, p: int = 5) -> torch.Tensor:
    """Smooth polynomial cutoff u(x) on [0, 1] (DimeNet eq. 8)."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    u = 1.0 / torch.clamp(x, min=1e-9) + a * x ** (p - 1) + b * x ** p \
        + c * x ** (p + 1)
    return torch.where(x < 1.0, u, torch.zeros_like(u))


def radial_basis(d: torch.Tensor, n_radial: int, cutoff: float,
                 p: int = 5) -> torch.Tensor:
    """Bessel RBF e_n(d) = sqrt(2/c) sin(n pi d / c) / d * u(d/c). [E, n]"""
    x = d / cutoff
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    env = envelope(x, p)                             # includes 1/x
    return (float(np.sqrt(2.0 / cutoff)) * env[:, None]
            * torch.sin(n[None, :] * np.pi * x[:, None]))


def _spherical_jn(l_max: int, x: torch.Tensor) -> torch.Tensor:
    """j_0..j_{l_max-1} via upward recurrence. x: [...] -> [..., l_max]."""
    x = torch.clamp(x, min=1e-6)
    out = [torch.sin(x) / x]
    if l_max > 1:
        out.append(torch.sin(x) / x ** 2 - torch.cos(x) / x)
        for l in range(1, l_max - 1):
            out.append((2 * l + 1) / x * out[l] - out[l - 1])
    return torch.stack(out, dim=-1)


def _legendre(l_max: int, z: torch.Tensor) -> torch.Tensor:
    """P_0..P_{l_max-1}(z) via recurrence. z: [...] -> [..., l_max]."""
    out = [torch.ones_like(z)]
    if l_max > 1:
        out.append(z)
        for l in range(1, l_max - 1):
            out.append(((2 * l + 1) * z * out[l] - l * out[l - 1]) / (l + 1))
    return torch.stack(out, dim=-1)


def spherical_basis(d: torch.Tensor, angle: torch.Tensor, roots: np.ndarray,
                    cutoff: float, p: int = 5) -> torch.Tensor:
    """a_{ln}(d, angle): [T, n_spherical * n_radial]. d: [T] distance of
    the (k -> j) edge; angle: [T] angle at j; roots: [n_spherical,
    n_radial] numpy constants."""
    from scipy.special import spherical_jn
    L, N = roots.shape
    dev = d.device
    x = d / cutoff
    env = envelope(x, p) * torch.clamp(x, min=1e-9)  # drop the 1/x pole
    arg = x[:, None, None] * torch.as_tensor(roots, dtype=torch.float32,
                                             device=dev)[None]
    jl = torch.stack([_spherical_jn(L, arg[:, l, :])[..., l]
                      for l in range(L)], dim=1)     # [T, L, N]
    # normalization sqrt(2 / (c^3 j_{l+1}(z_ln)^2))
    norm = np.sqrt(2.0 / (cutoff ** 3
                          * spherical_jn(np.arange(L)[:, None] + 1,
                                         roots) ** 2))
    yl = _legendre(L, torch.cos(angle))              # [T, L]
    yl = yl * torch.as_tensor(np.sqrt((2 * np.arange(L) + 1) / (4 * np.pi)),
                              dtype=torch.float32, device=dev)
    out = (jl * torch.as_tensor(norm, dtype=torch.float32, device=dev)[None]
           * yl[:, :, None] * env[:, None, None])
    return out.reshape(d.shape[0], L * N)


# ---------------------------------------------------------------------------
# Triplet construction (host-side)
# ---------------------------------------------------------------------------
def build_triplets(edge_index: np.ndarray, n_nodes: int, cap: int):
    """For each edge e=(j->i), list up to ``cap`` incoming edges (k->j), k!=i,
    in the order of a stable sort of the edges by dst.

    Returns (t_in [E*cap] edge ids (k->j), t_out [E*cap] edge ids (j->i),
    t_mask [E*cap]). Padded entries point at edge 0 with mask False.
    The reference's per-edge loop, vectorized over every (edge,
    incoming edge) candidate.
    """
    src = np.asarray(edge_index[0]).astype(np.int64)
    dst = np.asarray(edge_index[1]).astype(np.int64)
    E = len(src)
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=n_nodes)
    offsets = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    t_in = np.zeros((E, cap), np.int32)
    t_mask = np.zeros((E, cap), bool)
    n_cand = counts[src]                               # edges (k -> j)
    edge = np.repeat(np.arange(E), n_cand)
    first = np.cumsum(n_cand) - n_cand
    k = np.arange(len(edge)) - first[edge]
    cand = order[offsets[src[edge]] + k]
    ok = src[cand] != dst[edge]                        # drop backtrack k==i
    before = np.cumsum(ok) - ok                        # ok candidates before
    rank = before - before[first[edge]]                # ... within the edge
    take = ok & (rank < cap)
    t_in[edge[take], rank[take]] = cand[take]
    t_mask[edge[take], rank[take]] = True
    t_out = np.repeat(np.arange(E, dtype=np.int32), cap)
    return t_in.reshape(-1), t_out, t_mask.reshape(-1)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
class DimeNetBlock(nn.Module):
    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        h, nb = cfg.d_hidden, cfg.n_bilinear
        n_rbf, n_sbf = cfg.n_radial, cfg.n_spherical * cfg.n_radial
        self.rbf_gate = Dense(n_rbf, h, False, device, dtype)
        self.sbf_proj = Dense(n_sbf, nb, False, device, dtype)
        self.msg_pre = Dense(h, h, True, device, dtype)
        self.bilinear = nn.Parameter(torch.empty(nb, h, h, device=device,
                                                 dtype=dtype))
        self.msg_post = Dense(h, h, True, device, dtype)
        self.res1 = Dense(h, h, True, device, dtype)
        self.res2 = Dense(h, h, True, device, dtype)
        self.out = Dense(h, h, True, device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The bilinear tensor normal(0, 1/sqrt(h)) (``init_dimenet``)."""
        with torch.no_grad():
            self.bilinear.normal_(0.0, 1.0 / np.sqrt(self.bilinear.shape[1]),
                                  generator=generator)

    def forward(self, m, rbf, sbf, t_in, t_mask, e_mask):
        """One interaction block -> (messages [E, h], this block's edge
        output [E, h])."""
        act = act_fn("silu")
        E = m.shape[0]
        cap = t_in.shape[0] // E
        pre = act(self.msg_pre(m))                             # [E, h]
        sb = self.sbf_proj(sbf)                                # [T, nb]
        gathered = _take(pre, t_in) * t_mask[:, None].to(m.dtype)
        gathered = constrain(gathered, "triplets", "hidden")
        # sum_b sb[:, b] * (gathered @ W[b]), looped over the bilinear dim
        # so no [T, nb * h] tensor is built
        W = self.bilinear.to(m.dtype)
        tprod = torch.zeros_like(gathered)
        for b in range(W.shape[0]):
            tprod = tprod + sb[:, b:b + 1] * (gathered @ W[b])
        tprod = constrain(tprod, "triplets", "hidden")
        # t_out = repeat(arange(E), cap): the triplet -> edge sum is a
        # reshape and a sum over cap
        agg = constrain(tprod.reshape(E, cap, -1).sum(dim=1),
                        "edges", "hidden")
        m2 = act(self.msg_post(m * self.rbf_gate(rbf) + agg))
        m2 = m + m2                                            # residual
        m2 = m2 + act(self.res2(act(self.res1(m2))))
        m2 = m2 * e_mask[:, None].to(m.dtype)
        return m2, self.out(m2)


class DimeNet(nn.Module):
    """The reference's ``init_dimenet`` tree as a module: ``feat_proj``
    (node features) or ``atom_embed`` (atom types), ``rbf_proj``,
    ``edge_mlp``, ``out_init``, ``blocks.<i>``, ``head1``, ``head2``."""

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        pdt = dt(cfg.param_dtype)
        h = cfg.d_hidden
        self.cfg = cfg
        self.rbf_proj = Dense(cfg.n_radial, h, False, device, pdt)
        self.edge_mlp = Dense(3 * h, h, True, device, pdt)
        self.out_init = Dense(h, h, True, device, pdt)
        self.feat_proj = self.atom_embed = None
        if cfg.d_feat_in:
            self.feat_proj = Dense(cfg.d_feat_in, h, False, device, pdt)
        else:
            self.atom_embed = Embed(cfg.n_atom_types, h, device, pdt)
        self.blocks = nn.ModuleList(DimeNetBlock(cfg, device, pdt)
                                    for _ in range(cfg.n_blocks))
        self.head1 = Dense(h, h, True, device, pdt)
        self.head2 = Dense(h, cfg.n_targets, True, device, pdt)

    @property
    def device(self) -> torch.device:
        return self.rbf_proj.w.device

    def load_params(self, state: Dict[str, np.ndarray]) -> "DimeNet":
        """Load a ``params_from_jax`` state (numpy arrays) in place."""
        self.load_state_dict({k: torch.as_tensor(np.array(v))
                              for k, v in state.items()}, strict=True)
        return self


def init_dimenet(cfg, generator: Optional[torch.Generator] = None, *,
                 seed: int = 0, device: DeviceLike = None) -> DimeNet:
    """Random weights with the reference initializers' laws: dense
    normal(1/sqrt(d_in)), zero biases, the atom table truncated-normal
    (0.02), the bilinear tensors normal(1/sqrt(h))."""
    model = DimeNet(cfg, device)
    if model.device.type == "meta":     # shapes only: nothing to draw
        return model
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Dense, Embed, DimeNetBlock)):
            m.reset_parameters(generator)
    return model


def params_from_jax(tree) -> Dict[str, np.ndarray]:
    """The reference's ``init_dimenet`` tree -> a ``DimeNet`` state
    (``blocks`` unstacked into ``blocks.<i>``)."""
    return from_tree(tree)


def params_to_jax(state) -> Dict:
    """A ``DimeNet`` state -> the reference's tree of host arrays."""
    return to_tree(group(state.items()))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _index(idx, table):
    return table[idx]


def _take(table, idx, gather=F.embedding):
    """``gather(idx, table)``: the rows of ``table`` at ``idx``. Over a
    mesh (a ``DTensor`` either) the table is gathered whole onto every
    rank (an arbitrary index reaches any row) and each rank takes the
    rows of its own indices: the result laid out as ``idx``, the table's
    gradient a partial sum over the ranks that split ``idx``,
    reduce-scattered back to the table's layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(table, DTensor) and not isinstance(idx, DTensor):
        return gather(idx, table)
    from repro_torch.sharding.api import from_local, lay_out, reshard
    mesh = (idx if isinstance(idx, DTensor) else table).device_mesh
    whole = [Replicate()] * mesh.ndim
    idx = lay_out(idx, mesh, idx.placements if isinstance(idx, DTensor)
                  else whole)
    if any(p.is_shard() and p.dim != 0 for p in idx.placements):
        raise ValueError(f"row ids laid out {idx.placements}")
    grads = [Partial() if p.is_shard() else Replicate()
             for p in idx.placements]
    rows = gather(idx.to_local(), reshard(table, mesh, whole).to_local(
        grad_placements=grads))
    return from_local(rows, mesh, idx.placements,
                      (*idx.shape, *table.shape[1:]))


def _rowwise(fn, *xs):
    """``fn(*xs)`` of a function computed row by row (the bases of each
    edge or triplet); over a mesh each rank's own rows, from its local
    shards of ``xs`` (laid out alike, split by rows only)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    from repro_torch.sharding.api import from_local
    mesh, place = xs[0].device_mesh, xs[0].placements
    if any(x.placements != place for x in xs) or any(
            p.is_shard() and p.dim != 0 for p in place):
        raise ValueError(f"row-wise inputs laid out "
                         f"{[x.placements for x in xs]}")
    out = fn(*(x.to_local() for x in xs))
    return from_local(out, mesh, place, (xs[0].shape[0], *out.shape[1:]))


def _geometry(pos, src, dst, t_in, t_out):
    """Distances per edge and angles per triplet from positions."""
    rel = _take(pos, dst, _index) - _take(pos, src, _index)  # [E, 3] j -> i
    d = torch.linalg.norm(rel, dim=-1)               # [E]
    # angle at j between (k->j) and (j->i): vectors -rel[in] and rel[out]
    v1 = -_take(rel, t_in, _index)                   # j -> k
    v2 = _take(rel, t_out, _index)                   # j -> i
    cos = torch.sum(v1 * v2, -1) / torch.clamp(
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1),
        min=1e-9)
    return d, torch.arccos(torch.clamp(cos, -1.0, 1.0))


def dimenet_forward(model: DimeNet, inputs, cfg=None, *, task: str = "graph",
                    n_graphs: int = 1) -> torch.Tensor:
    """inputs: dict (tensors or host arrays, moved to the model's device)
    with pos [N, 3], edge_index [2, E], t_in / t_out / t_mask [T],
    node_mask [N], edge_mask [E], z [N] int | feat [N, d_feat], and
    graph_ids [N] for ``task="graph"``. -> per-graph energies
    [n_graphs, targets] or node logits [N, targets], f32."""
    cfg = cfg or model.cfg
    dev = model.device
    cdt = dt(cfg.dtype)
    act = act_fn("silu")
    inp = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    pos = inp["pos"].float()
    src, dst = inp["edge_index"][0].long(), inp["edge_index"][1].long()
    t_in, t_out = inp["t_in"].long(), inp["t_out"].long()
    t_mask, e_mask = inp["t_mask"], inp["edge_mask"]

    with torch.no_grad():
        d, angle = _geometry(pos, src, dst, t_in, t_out)
        rbf = _rowwise(lambda d_: radial_basis(
            d_, cfg.n_radial, cfg.cutoff, cfg.envelope_exponent).to(cdt),
            d)                                                 # [E, nr]
        roots = _roots(cfg.n_spherical, cfg.n_radial)
        sbf = _rowwise(lambda d_, a_: spherical_basis(
            d_, a_, roots, cfg.cutoff, cfg.envelope_exponent).to(cdt),
            _take(d, t_in, _index), angle)                     # [T, ns*nr]
    rbf = constrain(rbf, "edges", None)
    sbf = constrain(sbf, "triplets", None)

    # node embeddings
    if "feat" in inp:
        hN = act(model.feat_proj(inp["feat"].to(cdt)))
    else:
        hN = model.atom_embed(inp["z"].long(), cdt)
    hN = constrain(hN, "nodes", "hidden")

    # initial edge messages
    m = act(model.edge_mlp(torch.cat(
        [_take(hN, src), _take(hN, dst), model.rbf_proj(rbf)], -1)))
    m = constrain(m * e_mask[:, None].to(cdt), "edges", "hidden")

    outs = []
    remat = torch.is_grad_enabled()
    for block in model.blocks:
        args = (m, rbf, sbf, t_in, t_mask, e_mask)
        m, out_e = (checkpoint(block, *args, use_reentrant=False) if remat
                    else block(*args))
        outs.append(out_e)
    edge_out = constrain(model.out_init(m) + torch.stack(outs).sum(dim=0),
                         "edges", "hidden")

    # per-edge -> per-node sum (message direction: into dst)
    N = hN.shape[0]
    node_out = sorted_segment_sum(edge_out * e_mask[:, None].to(cdt), dst, N)
    node_out = constrain(node_out, "nodes", "hidden")
    node_out = model.head2(act(model.head1(node_out)))
    node_out = node_out * inp["node_mask"][:, None].to(cdt)

    if task == "node":
        return node_out.float()                              # [N, targets]
    gids = inp.get("graph_ids")
    gids = (torch.zeros(N, dtype=torch.long, device=dev) if gids is None
            else gids.long())
    return sorted_segment_sum(node_out.float(), gids, n_graphs)  # [G, t]


def dimenet_loss(model: DimeNet, inputs, targets, cfg=None, *,
                 task: str = "graph", n_graphs: int = 1) -> torch.Tensor:
    """MSE on energies (graph) or softmax xent on labels (node, weighted
    by the node mask)."""
    out = dimenet_forward(model, inputs, cfg, task=task, n_graphs=n_graphs)
    targets = torch.as_tensor(targets, device=out.device)
    if task == "graph":
        return torch.mean((out - targets.float()) ** 2)
    logp = torch.log_softmax(out, dim=-1)
    nll = -torch.gather(logp, 1, targets.long()[:, None])[:, 0]
    w = torch.as_tensor(inputs["node_mask"], device=out.device).float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
