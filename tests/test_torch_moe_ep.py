"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_ep``)
against the JAX package's ``moe_ep`` and the dense oracle.

Four gloo ranks on the CPU, a (2, 2) ("data", "model") mesh: each rank
is a process of its own (``tests/torch_ep_ranks.py``, a ``FileStore``
rendezvous), started with a timeout. The JAX package runs its
``moe_ep`` in a subprocess of its own on 4 forced host devices with the
same mesh (its device count is fixed at its first use). Both take the
Moonshot smoke MoE layer the JAX package drew (E = 4 experts, top 2,
shared experts; weights carried across as arrays) and one seeded batch
x [4, 8, d]; a rank runs its data shard of x.

Held, at capacity 256 (cap_send 256, C_loc 20) and at capacity 4 (sends
dropped past 4 a lane):
  * y of every rank equal to the reference's rows to 1e-5 relative
    (Frobenius) and 1e-5 max abs: f32 products in another order;
  * the keep masks of both stages integer-equal to the reference's
    dispatch rule (``_positions_in_expert`` against cap_send, then
    against C_loc on the slots an owner receives), computed by the JAX
    package's own functions on its routes;
  * at capacity 256, y against the dense oracle to 2e-3 max abs and aux
    within 1e-5 (``tests/test_moe_ep.py``'s limits);
  * a finite, nonzero ``w1`` gradient, with the weights whole on every
    rank and as DTensors (experts over ``model``, FSDP dim over
    ``data``), the latter's y equal to the former's to 1e-6.

A one-rank ("data", "model") mesh in this process takes the
expert-parallel path too, with its own capacities: equal to the
reference's ``moe_ep`` on a (1, 1) mesh, and not to ``moe_capacity`` at
the same capacity.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import moe as jmoe
from repro.models.layers import tree_paths
from repro.sharding.api import lm_rules as j_lm_rules
from repro.sharding.api import mesh_context as j_mesh_context
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh, process_group
from repro_torch.models import moe as tmoe
from repro_torch.sharding.api import lm_rules, mesh_context

ARCH = "moonshot-v1-16b-a3b"
CAPACITIES = (256, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
REL, ATOL = 1e-5, 1e-5

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models.layers import tree_paths
from repro.models.moe import (init_moe, moe_dense, moe_ep,
                              _positions_in_expert)
from repro.sharding.api import mesh_context, lm_rules

arch, out, caps = sys.argv[1], sys.argv[2], [int(c) for c in sys.argv[3:]]
cfg = get_smoke_config(arch)
mesh = jax.make_mesh((2, 2), ("data", "model"))
p = init_moe(jax.random.PRNGKey(0), cfg)
x = np.random.default_rng(1).normal(
    size=(4, 8, cfg.d_model)).astype(np.float32)
res = {"arch": arch, "capacities": np.array(caps), "x": x}
res.update({"p/" + k: np.asarray(v) for k, v in tree_paths(p)})
with mesh, mesh_context(mesh, lm_rules("data")):
    for cap in caps:
        y, aux = jax.jit(lambda p, x: moe_ep(p, x, cfg, capacity=cap))(p, x)
        res[f"y{cap}"], res[f"aux{cap}"] = np.asarray(y), float(aux)
    yd, ad = moe_dense(p, jnp.asarray(x), cfg)
res["y_dense"], res["aux_dense"] = np.asarray(yd), float(ad)

# the reference's dispatch rule on its own routes, per data shard
E, k, n_shards, n_data = cfg.n_experts, cfg.top_k, 2, 2
E_loc = E // n_shards
for d in range(n_data):
    x2d = jnp.asarray(x[2 * d:2 * d + 2].reshape(-1, cfg.d_model))
    T_loc = x2d.shape[0]
    probs = jax.nn.softmax(x2d @ p["router"]["w"], axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    ids_f = ids.reshape(-1)
    for cap in caps:
        cap_send = cap or int(max(8, round(T_loc * k / n_shards
                                           * cfg.capacity_factor)))
        C_loc = int(max(8, round(T_loc * n_data * k / E
                                 * cfg.capacity_factor)))
        dst = ids_f // E_loc
        keep = _positions_in_expert(dst, n_shards) < cap_send
        slot = jnp.where(keep, dst * cap_send
                         + _positions_in_expert(dst, n_shards),
                         n_shards * cap_send)
        eid = jnp.full((n_shards * cap_send,), -1, jnp.int32).at[slot].set(
            ids_f % E_loc, mode="drop").reshape(n_shards, cap_send)
        res[f"keep{cap}_d{d}"] = np.asarray(keep)
        res[f"caps{cap}"] = np.array([cap_send, C_loc])
        for j in range(n_shards):
            # owner j receives lane j of every sender along "model"; the
            # senders of one data shard route the same tokens
            re = jnp.tile(eid[j], n_shards)
            valid = re >= 0
            pos = _positions_in_expert(jnp.where(valid, re, E_loc),
                                       E_loc + 1)
            res[f"keep2_{cap}_d{d}_m{j}"] = np.asarray(valid & (pos < C_loc))
np.savez(out, **res)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's run, then the port's four ranks -> (reference
    arrays, [per-rank arrays])."""
    tmp = tmp_path_factory.mktemp("ep")
    ref = str(tmp / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, ARCH, ref,
                        *map(str, CAPACITIES)], capture_output=True,
                       text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stdout + r.stderr
    store = str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_ep_ranks.py"),
         ref, str(tmp), str(rank), "4", store], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return (dict(np.load(ref)),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


def _rows(a, d):
    return a[2 * d:2 * d + 2]


def _close(got, want, rel=REL, atol=ATOL):
    err = float(np.abs(got - want).max())
    r = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert err <= atol and r <= rel, (err, r)


@pytest.mark.parametrize("cap", CAPACITIES)
def test_y_and_aux_equal_reference(ranks, cap):
    ref, outs = ranks
    for out in outs:
        d, _ = out["coords"]
        _close(out[f"y{cap}"], _rows(ref[f"y{cap}"], d))
        assert abs(float(out[f"aux{cap}"]) - float(ref[f"aux{cap}"])) < 1e-6


@pytest.mark.parametrize("cap", CAPACITIES)
def test_keep_masks_integer_equal_reference(ranks, cap):
    ref, outs = ranks
    dropped = 0
    for out in outs:
        d, m = out["coords"]
        assert out[f"caps{cap}"].tolist() == ref[f"caps{cap}"].tolist()
        assert np.array_equal(out[f"keep{cap}"], ref[f"keep{cap}_d{d}"])
        assert np.array_equal(out[f"keep2_{cap}"],
                              ref[f"keep2_{cap}_d{d}_m{m}"])
        dropped += int((~out[f"keep{cap}"]).sum())
    # capacity 4 drops sends (so the y check above covers drops)
    assert (dropped > 0) == (cap == 4)


def test_matches_dense_oracle(ranks):
    ref, outs = ranks
    for out in outs:
        d, _ = out["coords"]
        err = float(np.abs(out["y256"] - _rows(ref["y_dense"], d)).max())
        assert err < 2e-3, err
        assert abs(float(out["aux256"]) - float(ref["aux_dense"])) < 1e-5


def test_w1_gradient_finite_and_nonzero(ranks):
    ref, outs = ranks
    E = j_smoke(ARCH).n_experts
    for out in outs:
        d, m = out["coords"]
        g = out["w1_grad"]
        assert np.isfinite(g).all()
        mine = slice(m * E // 2, (m + 1) * E // 2)
        assert np.abs(g[mine]).sum() > 0            # this rank's experts
        rest = np.ones(E, bool)
        rest[mine] = False
        assert not g[rest].any()                    # no others
        gd = out["w1_grad_dtensor"]
        assert np.isfinite(gd).all() and np.abs(gd).sum() > 0
        assert np.isfinite(out["router_grad_dtensor"]).all()


def test_dtensor_weights_equal_whole_weights(ranks):
    """Experts sharded over ``model`` and their d over ``data`` (each
    rank holds [E / 2, d / 2, f] of w1) give the same y and aux."""
    ref, outs = ranks
    cfg = get_smoke_config(ARCH)
    for out in outs:
        assert out["w1_local_shape"].tolist() == [
            cfg.n_experts // 2, cfg.d_model // 2, cfg.moe_d_ff]
        _close(out["y_dtensor"], out["y256"], rel=1e-6, atol=1e-6)
        assert abs(float(out["aux_dtensor"]) - float(out["aux256"])) < 1e-7


def test_constrain_on_four_ranks(ranks):
    """("batch", "ff") under ``lm_rules``: rows over ``data``, columns
    over ``model``; each rank holds its [2, 3] block."""
    _, outs = ranks
    full = np.arange(24.0).reshape(4, 6)
    for out in outs:
        d, m = out["coords"]
        assert np.array_equal(out["constrain_local"],
                              full[2 * d:2 * d + 2, 3 * m:3 * m + 3])


# ----------------------------------------------------------- one rank
def _layer(seed=5):
    cfg = j_smoke(ARCH)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    m = tmoe.MoE(get_smoke_config(ARCH))
    m.load_state_dict({k.replace("/", "."): torch.tensor(np.asarray(v))
                       for k, v in tree_paths(p)})
    return p, cfg, m.requires_grad_(False)


@pytest.mark.parametrize("capacity", [None, 4])
def test_one_rank_mesh_takes_the_expert_parallel_path(capacity):
    p, jc, m = _layer()
    tc = get_smoke_config(ARCH)
    x = np.random.default_rng(6).normal(size=(2, 16, jc.d_model)).astype(
        np.float32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jmesh, j_mesh_context(jmesh, j_lm_rules("data")):
        jy, jaux = jax.jit(lambda p, x: jmoe.moe_ep(
            p, x, jc, capacity=capacity))(p, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with process_group("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        st = {}
        with mesh_context(mesh, lm_rules("data")):
            y, aux = tmoe.moe_ep(m, xt, tc, capacity=capacity, stats=st)
    assert (st["cap_send"], st["C_loc"]) == tmoe.ep_capacities(
        32, 1, 1, tc, capacity)
    _close(y.numpy(), np.asarray(jy))
    assert abs(float(aux) - float(jaux)) < 1e-6
    yc, _ = tmoe.moe_capacity(m, xt, tc, capacity=capacity)
    if capacity is None:     # one lane holds every assignment: no send drop
        assert bool(st["keep"].all())
    else:                    # 4 slots in all vs 4 an expert: other drops
        assert int(st["keep"].sum()) == 4
        assert not torch.allclose(y, yc)


def test_ep_capacities_are_the_references():
    cfg = get_smoke_config(ARCH)
    assert tmoe.ep_capacities(16, 2, 2, cfg) == (20, 20)
    assert tmoe.ep_capacities(16, 2, 2, cfg, 256) == (256, 20)
    assert tmoe.ep_capacities(2, 1, 4, cfg) == (8, 8)      # the floor of 8
    # round half to even, as the reference's Python round
    assert tmoe.ep_capacities(5, 1, 1, cfg) == (12, 8)     # 12.5 -> 12


def test_without_a_model_axis_it_is_the_capacity_path():
    _, _, m = _layer(7)
    tc = get_smoke_config(ARCH)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 8, tc.d_model)).astype(np.float32))
    yc, ac = tmoe.moe_capacity(m, x, tc)
    with process_group("cpu"):
        mesh = make_mesh((1,), ("data",), "cpu")
        with mesh_context(mesh, lm_rules("data")):
            ye, ae = tmoe.moe_ep(m, x, tc)
    assert torch.equal(ye, yc) and torch.equal(ae, ac)
