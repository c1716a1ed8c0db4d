"""The port's DimeNet and neighbor sampler (``repro_torch.models.gnn``,
``repro_torch.launch.steps.make_gnn_train_step``) against the JAX
package's at the SMOKE size (2 blocks, hidden 32, bilinear 4, spherical
3, radial 4, triplet cap 4) and at the published basis sizes (spherical
7, radial 6), the weights carried over by ``params_from_jax`` and the
same numpy inputs.

Integer-equal: ``build_triplets`` (random graphs with self loops and
repeated edges) and ``NeighborSampler``'s nodes, edges and masks (the
same ``default_rng(seed)`` draws). Floats, tolerances: the Bessel roots
rtol 1e-12 (the same scipy calls); the bases rtol 1e-5 / atol 1e-5 (f32
recurrences in another order), and where the upward recurrence of j_l
at x < l leaves the reference far from the f64 truth, the port no
farther than 3x (``_as_accurate``); forward outputs in f32 rtol 1e-4 / atol
1e-5 (six dense layers a block over sums of up to cap * h terms,
observed <= 3e-6); the loss rtol 1e-5; gradients rtol 1e-4 and atol
1e-5 of the tensor's largest magnitude (gradients of ~1e2 whose entries
cancel; observed 4e-6 of it); three train steps' losses rtol 1e-4 and
parameters rtol 1e-3 / atol 1e-5 (AdamW's first steps divide by
sqrt(v) of tiny gradients). The
configs' own bf16 compute: forward within atol 0.05 of the reference's
(at outputs of magnitude ~1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.launch import steps as jsteps
from repro.models.gnn import dimenet as jdn
from repro.models.gnn.sampler import NeighborSampler as JSampler
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.segment import sorted_segment_sum
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import dimenet as tdn
from repro_torch.models.gnn.sampler import NeighborSampler
from repro_torch.train import CheckpointManager
from repro_torch.train.params import (load_tree, param_groups, to_tree,
                                      tree_paths, value_and_grad)
from repro_torch.train.trainer import load_state_tree, state_to_tree

OUT = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=1e-4, atol=1e-5)
BASIS = dict(rtol=1e-5, atol=1e-5)


def _cfgs(dtype="float32", **kw):
    jc = dataclasses.replace(j_get_smoke("dimenet"), dtype=dtype, **kw)
    tc = dataclasses.replace(get_smoke_config("dimenet"), dtype=dtype, **kw)
    return jc, tc


def _pair(seed=0, dtype="float32", **kw):
    jc, tc = _cfgs(dtype, **kw)
    params = jdn.init_dimenet(jax.random.PRNGKey(seed), jc)
    model = tdn.DimeNet(tc, device="cpu").load_params(
        tdn.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, jc, model, tc


def _close(got_tree, want_tree, scaled=False, **tol):
    """Every leaf allclose; ``scaled``: atol is relative to the leaf's
    largest magnitude (gradients of ~1e2 with cancelling entries)."""
    got = dict(tree_paths(got_tree))
    want = tree_paths(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == [p for p, _ in want]
    for path, w in want:
        t = dict(tol)
        if scaled:
            t["atol"] = tol["atol"] * max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(got[path], w, err_msg=path, **t)


def molecules(n_graphs, n_atoms, n_edges, cap, seed):
    """Molecule-cell inputs: ``n_graphs`` graphs of ``n_atoms`` atoms
    (positions normal(0, 1.2), atom types < 10) and ``n_edges`` directed
    edges each (both directions of random atom pairs)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0.0, 1.2, (n_graphs * n_atoms, 3)).astype(np.float32)
    src, dst = [], []
    for g in range(n_graphs):
        a = rng.integers(0, n_atoms, n_edges // 2)
        b = (a + rng.integers(1, n_atoms, n_edges // 2)) % n_atoms
        src += list(g * n_atoms + np.concatenate([a, b]))
        dst += list(g * n_atoms + np.concatenate([b, a]))
    ei = np.stack([src, dst]).astype(np.int32)
    N, E = n_graphs * n_atoms, ei.shape[1]
    t_in, t_out, t_mask = jdn.build_triplets(ei, N, cap)
    inputs = {"pos": pos, "edge_index": ei, "t_in": t_in, "t_out": t_out,
              "t_mask": t_mask, "node_mask": np.ones(N, bool),
              "edge_mask": rng.random(E) < 0.95,
              "z": rng.integers(0, 10, N).astype(np.int32),
              "graph_ids": np.repeat(np.arange(n_graphs), n_atoms).astype(
                  np.int32)}
    targets = rng.normal(size=(n_graphs, 1)).astype(np.float32)
    return inputs, targets


def sampled(n_nodes, deg, d_feat, n_cls, seeds, fanouts, cap, seed):
    """Node-cell inputs from ``NeighborSampler`` over a random graph:
    features and positions per original node, padded entries masked."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n_nodes, n_nodes * deg),
                   np.repeat(np.arange(n_nodes), deg)])
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    pos = rng.uniform(0, 4, (n_nodes, 3)).astype(np.float32)
    labels = rng.integers(0, n_cls, n_nodes).astype(np.int32)
    sampler = NeighborSampler(ei, n_nodes, fanouts, seed=seed)
    nodes, sub, nmask, emask = sampler.sample(seeds)
    t_in, t_out, t_mask = tdn.build_triplets(sub, len(nodes), cap)
    inputs = {"pos": pos[nodes], "edge_index": sub, "t_in": t_in,
              "t_out": t_out, "t_mask": t_mask, "node_mask": nmask,
              "edge_mask": emask, "feat": feat[nodes]}
    return inputs, labels[nodes]


# ------------------------------------------------------------------ bases
@pytest.mark.parametrize("ns,nr", [(3, 4), (7, 6)])
def test_bessel_roots_match_reference(ns, nr):
    np.testing.assert_allclose(tdn.spherical_bessel_roots(ns, nr),
                               jdn.spherical_bessel_roots(ns, nr),
                               rtol=1e-12)


def _as_accurate(got, want, truth, arg, order):
    """Where j_l's argument is at least l (the upward recurrence is well
    conditioned) the port agrees with the reference to BASIS; in every
    column (an order l, or (l, n)) the port's largest error against the
    f64 truth is at most 3x the reference's (observed 1.74x). Below that
    argument the f32 recurrence amplifies rounding ~(2l+1)!!/x^l in both
    packages alike, so there they agree only as well as each agrees with
    the truth."""
    good = arg >= order
    np.testing.assert_allclose(got[good], want[good], **BASIS)
    err_w, err_g = np.abs(want - truth), np.abs(got - truth)
    assert (err_g.max(0) <= 3 * err_w.max(0) + BASIS["atol"]).all(), (
        err_g.max(0), err_w.max(0))


def _sbf_f64(d, ang, roots, cutoff, p=5):
    """spherical_basis in f64 with scipy's j_l and P_l (the truth)."""
    from scipy.special import eval_legendre, spherical_jn
    L, N = roots.shape
    x = d.astype(np.float64) / cutoff
    a, b, c = -(p + 1) * (p + 2) / 2.0, p * (p + 2.0), -p * (p + 1) / 2.0
    env = np.where(x < 1, 1 / x + a * x ** (p - 1) + b * x ** p
                   + c * x ** (p + 1), 0.0) * x
    jl = spherical_jn(np.arange(L)[None, :, None],
                      x[:, None, None] * roots[None])
    norm = np.sqrt(2.0 / (cutoff ** 3 * spherical_jn(
        np.arange(L)[:, None] + 1, roots) ** 2))
    yl = eval_legendre(np.arange(L)[None], np.cos(ang.astype(np.float64))[
        :, None]) * np.sqrt((2 * np.arange(L) + 1) / (4 * np.pi))
    return (jl * norm[None] * yl[:, :, None] * env[:, None, None]).reshape(
        len(d), L * N)


@pytest.mark.parametrize("ns,nr", [(3, 4), (7, 6)])
def test_bases_match_reference(ns, nr):
    from scipy.special import spherical_jn
    rng = np.random.default_rng(0)
    d = rng.uniform(0.3, 6.0, 300).astype(np.float32)
    ang = rng.uniform(0, np.pi, 300).astype(np.float32)
    roots = jdn.spherical_bessel_roots(ns, nr)
    td, ta = torch.from_numpy(d), torch.from_numpy(ang)
    np.testing.assert_allclose(tdn.envelope(td / 5.0).numpy(),
                               np.asarray(jdn.envelope(jnp.asarray(d / 5.0))),
                               **BASIS)
    np.testing.assert_allclose(
        tdn.radial_basis(td, nr, 5.0).numpy(),
        np.asarray(jdn.radial_basis(jnp.asarray(d), nr, 5.0)), **BASIS)
    np.testing.assert_allclose(
        tdn._legendre(ns, torch.cos(ta)).numpy(),
        np.asarray(jdn._legendre(ns, jnp.cos(jnp.asarray(ang)))), **BASIS)
    order = np.arange(ns)[None]
    _as_accurate(tdn._spherical_jn(ns, td).numpy(),
                 np.asarray(jdn._spherical_jn(ns, jnp.asarray(d))),
                 spherical_jn(order, d[:, None].astype(np.float64)),
                 d[:, None], order)
    _as_accurate(tdn.spherical_basis(td, ta, roots, 5.0).numpy(),
                 np.asarray(jdn.spherical_basis(jnp.asarray(d),
                                                jnp.asarray(ang), roots,
                                                5.0)),
                 _sbf_f64(d, ang, roots, 5.0),
                 (d[:, None] / 5.0 * roots.reshape(1, -1)),
                 np.repeat(np.arange(ns), nr)[None])


# ------------------------------------------------------- host structures
@pytest.mark.parametrize("seed", range(6))
def test_build_triplets_integer_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    E = int(rng.integers(0, 400))
    ei = rng.integers(0, n, (2, E)).astype(np.int32)
    cap = int(rng.integers(1, 9))
    for got, want in zip(tdn.build_triplets(ei, n, cap),
                         jdn.build_triplets(ei, n, cap)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fanouts,n_seeds,seed", [((15, 10), 16, 0),
                                                  ((3, 2, 2), 8, 1),
                                                  ((5,), 32, 2)])
def test_sampler_integer_equal(fanouts, n_seeds, seed):
    """Nodes, edges and masks of two consecutive ``sample`` calls (the
    generator carries over), on a graph with isolated nodes."""
    rng = np.random.default_rng(seed)
    n = 400
    ei = np.stack([rng.integers(0, n, 3000), rng.integers(0, n // 2, 3000)])
    a, b = NeighborSampler(ei, n, fanouts, seed=seed), JSampler(
        ei, n, fanouts, seed=seed)
    assert a.node_budget(n_seeds) == b.node_budget(n_seeds)
    assert a.edge_budget(n_seeds) == b.edge_budget(n_seeds)
    for _ in range(2):
        seeds = rng.integers(0, n, n_seeds)
        for got, want in zip(a.sample(seeds), b.sample(seeds)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_sorted_segment_sum_matches_index_add():
    """Every segment's rows summed in row order (empty segments 0);
    gradients flow to every row."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(200, 5)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 37, 200)).long()
    want = torch.zeros(40, 5).index_add_(0, seg, x)
    got = sorted_segment_sum(x.requires_grad_(), seg, 40)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    got.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones((200, 5)))


# ---------------------------------------------------------------- forward
def _jforward(params, inputs, jc, **kw):
    return np.asarray(jdn.dimenet_forward(
        params, jax.tree_util.tree_map(jnp.asarray, inputs), jc, **kw))


def test_graph_task_forward_matches_reference():
    params, jc, model, tc = _pair(seed=1)
    inputs, _ = molecules(6, 12, 24, tc.triplet_cap, seed=2)
    want = _jforward(params, inputs, jc, task="graph", n_graphs=6)
    with torch.no_grad():
        got = tdn.dimenet_forward(model, inputs, task="graph", n_graphs=6)
    assert got.shape == (6, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **OUT)


def test_node_task_forward_matches_reference():
    params, jc, model, tc = _pair(seed=3, d_feat_in=24, n_targets=5)
    inputs, _ = sampled(300, 6, 24, 5, np.arange(8), (4, 3),
                        tc.triplet_cap, seed=4)
    want = _jforward(params, inputs, jc, task="node")
    with torch.no_grad():
        got = tdn.dimenet_forward(model, inputs, task="node")
    assert got.shape == (len(inputs["pos"]), 5)
    np.testing.assert_allclose(got.numpy(), want, **OUT)
    assert (got.numpy()[~inputs["node_mask"]] == 0).all()


def test_published_basis_sizes_match_reference():
    """Spherical 7, radial 6, cap 8 (the published widths' bases) at a
    narrow hidden width."""
    params, jc, model, tc = _pair(seed=5, n_spherical=7, n_radial=6,
                                  n_bilinear=8, triplet_cap=8)
    inputs, _ = molecules(3, 10, 30, 8, seed=6)
    want = _jforward(params, inputs, jc, task="graph", n_graphs=3)
    with torch.no_grad():
        got = tdn.dimenet_forward(model, inputs, task="graph", n_graphs=3)
    np.testing.assert_allclose(got.numpy(), want, **OUT)


def test_bf16_forward_matches_reference_loosely():
    params, jc, model, tc = _pair(seed=7, dtype="bfloat16")
    inputs, _ = molecules(4, 10, 20, tc.triplet_cap, seed=8)
    want = _jforward(params, inputs, jc, task="graph", n_graphs=4)
    with torch.no_grad():
        got = tdn.dimenet_forward(model, inputs, task="graph", n_graphs=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.05)


# ------------------------------------------------------- loss, gradients
@pytest.mark.parametrize("task", ["graph", "node"])
def test_loss_and_gradients_match_reference(task):
    if task == "graph":
        params, jc, model, tc = _pair(seed=9)
        inputs, targets = molecules(5, 12, 24, tc.triplet_cap, seed=10)
        kw = dict(task="graph", n_graphs=5)
    else:
        params, jc, model, tc = _pair(seed=9, d_feat_in=16, n_targets=4)
        inputs, targets = sampled(200, 5, 16, 4, np.arange(6), (3, 2),
                                  tc.triplet_cap, seed=10)
        kw = dict(task="node")
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    jl, jg = jax.value_and_grad(lambda p: jdn.dimenet_loss(
        p, jin, jnp.asarray(targets), jc, **kw))(params)
    calls = []
    orig = tdn.checkpoint

    def counted(fn, *a, **k):
        calls.append(fn)
        return orig(fn, *a, **k)

    tdn.checkpoint = counted
    try:
        loss, _, grads = value_and_grad(
            lambda m, i: (tdn.dimenet_loss(m, i, targets, **kw), {}), model,
            inputs)
    finally:
        tdn.checkpoint = orig
    assert len(calls) == tc.n_blocks          # each block recomputed
    np.testing.assert_allclose(float(loss), float(jl), **LOSS)
    _close(to_tree(grads), jg, scaled=True, **GRAD)
    for g in tree_paths(to_tree(grads)):
        assert np.isfinite(g[1]).all(), g[0]


# ------------------------------------------------------- train, ckpts
def test_three_train_steps_match_reference(tmp_path):
    """Three ``make_gnn_train_step`` steps against the reference's, then
    each package's checkpoint restored by the other, bit for bit, and a
    fourth step."""
    params, jc, model, tc = _pair(seed=11)
    batches = []
    for s in range(4):
        inputs, targets = molecules(4, 10, 20, tc.triplet_cap, seed=20 + s)
        batches.append(dict(inputs, targets=targets))
    jstep, jopt = jsteps.make_gnn_train_step(jc, "graph", n_graphs=4,
                                             lr=1e-3)
    jstep = jax.jit(jstep)
    step, opt = tsteps.make_gnn_train_step(tc, "graph", n_graphs=4, lr=1e-3,
                                           device="cpu")
    jp, js = params, jopt.init(params)
    state = opt.init(model)
    for b in batches[:3]:
        jp, js, jout = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray, b))
        state, out = step(model, state, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(out[k]), float(jout[k]),
                                       rtol=1e-4)
    _close(to_tree(param_groups(model)), jp, rtol=1e-3, atol=1e-5)
    assert state["step"] == int(js["step"]) == 3
    # the port's checkpoint, restored by the reference
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(
        3, {"params": to_tree(param_groups(model)),
            "opt_state": state_to_tree(state)})
    _, tree, _ = JCheckpointManager(str(tmp_path / "port")).restore()
    jp2 = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    js2 = jax.tree_util.tree_map(jnp.asarray, tree["opt_state"])
    _close(to_tree(param_groups(model)), jp2, rtol=0, atol=0)
    jp2, js2, jout = jstep(jp2, js2, jax.tree_util.tree_map(jnp.asarray,
                                                            batches[3]))
    # the reference's checkpoint, restored by the port
    JCheckpointManager(str(tmp_path / "jax"), async_write=False).save(
        3, {"params": jp, "opt_state": js})
    _, _, fresh, _ = _pair(seed=12)
    _, tree, _ = CheckpointManager(str(tmp_path / "jax")).restore()
    groups = param_groups(fresh)
    load_tree(groups, tree["params"])
    state3 = load_state_tree(opt.init(fresh), tree["opt_state"])
    _close(to_tree(groups), jp, rtol=0, atol=0)
    state3, out = step(fresh, state3, batches[3])
    jp3, _, jout = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray,
                                                        batches[3]))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               rtol=1e-4)
    _close(to_tree(param_groups(fresh)), jp3, rtol=1e-3, atol=1e-5)


def test_params_round_trip_and_seeded_init():
    params, jc, model, tc = _pair(seed=13, d_feat_in=8)
    assert "feat_proj" in params and model.atom_embed is None
    _close(tdn.params_to_jax(model.state_dict()), params, rtol=0, atol=0)
    a = tdn.init_dimenet(tc, seed=0, device="cpu")
    b = tdn.init_dimenet(tc, seed=0, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    bil = a.blocks[0].bilinear.detach()
    np.testing.assert_allclose(float(bil.std()), tc.d_hidden ** -0.5,
                               rtol=0.1)
