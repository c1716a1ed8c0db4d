"""The port's meshes and sharding rules (``repro_torch.launch.mesh``,
``repro_torch.sharding``) against the JAX package's.

* every rule table equals the reference's, entry by entry, for each
  data-axis form (``"data"``, ``("pod", "data")``) and attention shard;
* ``spec_for_path``, ``param_specs`` and ``opt_state_specs`` give the
  reference's spec for every parameter path of the Kimi, Moonshot,
  Qwen and ColBERT smoke configs, once the reference's stacked leading
  ``None`` is dropped (the port holds a stack's layers apart; its
  Adafactor slots are stacked, so they keep it); the four passing rule
  tests of ``tests/test_sharding.py`` are mirrored;
* ``serve_device_table`` and ``distinct_row`` give the reference's
  results on the same device counts; the production meshes keep their
  shapes (built over the fake process group);
* ``constrain`` is a no-op without a context and lays a tensor out
  under one (held to its own test: the reference's
  ``test_constrain_applies_in_context`` fails in the JAX package);
* a process group opened by ``process_group`` is gone after it.

Specs are compared as tuples of entries: the reference's
``PartitionSpec`` and the port's ``P`` both hold None, an axis name or
a tuple of axis names a dim.
"""
import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import repro.launch.mesh as j_mesh
from repro.configs import get_smoke_config as j_smoke
from repro.models.layers import tree_paths
from repro.sharding import api as j_api
from repro.sharding import params as j_params
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.sharding import api as t_api
from repro_torch.sharding import params as t_params
from repro_torch.sharding.api import P
from repro_torch.train.params import param_groups

FSDP = ["data", ("pod", "data"), None]


def _entries(spec):
    return tuple(spec)


# ------------------------------------------------------------- rule tables
TABLES = [
    ("lm_rules", dict(attn_shard="heads")),
    ("lm_rules", dict(attn_shard="sequence")),
    ("lm_decode_rules", {}),
    ("lm_long_decode_rules", {}),
    ("gnn_rules", {}),
    ("recsys_rules", {}),
    ("retrieval_rules", {}),
]


@pytest.mark.parametrize("batch", ["data", ("pod", "data")])
@pytest.mark.parametrize("name,kw", TABLES)
def test_rule_table_equals_reference(name, kw, batch):
    assert getattr(t_api, name)(batch, **kw) == \
        getattr(j_api, name)(batch, **kw)


def test_serve_rules_equal_reference():
    assert t_api.serve_rules() == j_api.serve_rules()
    assert t_api.serve_rules("s", "r") == j_api.serve_rules("s", "r")


def test_rules_consistency():
    """``tests/test_sharding.py::test_rules_consistency``, on the port."""
    r = t_api.lm_rules("data", attn_shard="heads")
    assert r["heads"] == "model" and r["qseq"] is None
    r2 = t_api.lm_rules("data", attn_shard="sequence")
    assert r2["heads"] is None and r2["qseq"] == "model"
    assert t_api.lm_decode_rules("data")["kvseq"] == "model"
    rl = t_api.lm_long_decode_rules("data")
    assert rl["kvseq"] == ("data", "model") and rl["batch"] is None


# --------------------------------------------------------- parameter specs
def test_lm_param_rules_matching():
    """``tests/test_sharding.py::test_lm_param_rules_matching``: the same
    paths at the reference's (stacked) ranks give the same specs."""
    rules = t_params.lm_param_rules("data")
    sfp = t_params.spec_for_path
    assert sfp("moe_layers/attn/wq/w", 3, rules) == P(None, "data", "model")
    assert sfp("dense_layers/attn/wo/w", 3, rules) == \
        P(None, "model", "data")
    assert sfp("moe_layers/moe/w1", 4, rules) == \
        P(None, "model", "data", None)
    assert sfp("embed/table", 2, rules) == P("model", "data")
    assert sfp("final_norm/scale", 1, rules) == P(None)
    assert sfp("unknown/thing", 2, rules) == P()
    # the port's per-layer rank: the stacked None dropped
    assert sfp("moe_layers/moe/w1", 3, rules) == P("model", "data", None)


def _lm_pair(arch):
    """(reference params' shapes, the port's model on the CPU) of a
    smoke config; ColBERT's trunk and head as its ``init_colbert``."""
    if arch == "colbertv2":
        from repro.models.colbert import init_colbert as j_init
        from repro_torch.models.colbert import init_colbert as t_init
    else:
        from repro.models.transformer import init_transformer as j_init
        from repro_torch.models.transformer import init_transformer as t_init
    jc, tc = j_smoke(arch), get_smoke_config(arch)
    jp = jax.eval_shape(lambda k: j_init(k, jc), jax.random.PRNGKey(0))
    return jp, t_init(tc, device="cpu")


def _flat_specs(tree, prefix=""):
    """The reference's spec tree (nested dicts and lists) -> {path: spec}."""
    if isinstance(tree, JP):
        return {prefix[:-1]: tree}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}{k}/"))
    return out


def _rules(arch, fsdp, which):
    rules = which.lm_param_rules(fsdp)
    if arch == "colbertv2":            # input_specs' ColBERT variant
        rules = [(r"embed/table$", (None, None)),
                 (r"lm_head/w$", (None, None)),
                 (r"lm_head/b$", (None,))] + rules
    return rules


# the reference ColBERT's trunk keeps an LM head its encoder never reads;
# the port's encoder has none (``models/colbert.py`` ``params_from_jax``)
_NO_PORT = {"colbertv2": {"trunk/lm_head/w"}}
_NO_PORT.update({a: set() for a in ("kimi-k2-1t-a32b", "moonshot-v1-16b-a3b",
                                    "qwen3-0.6b", "qwen2.5-14b")})
LM_ARCHS = ["kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "qwen3-0.6b",
            "qwen2.5-14b", "colbertv2"]


@pytest.mark.parametrize("fsdp", FSDP)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_reference(arch, fsdp):
    jp, model = _lm_pair(arch)
    want = _flat_specs(j_params.param_specs(jp, _rules(arch, fsdp,
                                                         j_params)))
    jshape = {p: a.shape for p, a in tree_paths(jp)}
    got = t_params.param_specs(model, _rules(arch, fsdp, t_params))
    groups = param_groups(model)
    assert set(want) == set(jshape)
    assert set(want) - set(got) == _NO_PORT[arch] and set(got) <= set(want)
    for path, spec in got.items():
        w = _entries(want[path])
        if isinstance(spec, list):      # a stack: the layer axis dropped
            assert len(spec) == jshape[path][0]
            assert w == () or w[0] is None, (path, w)
            for s, t in zip(spec, groups[path]):
                assert _entries(s) == (w[1:] if w else ()), (path, s, w)
                assert len(s) in (0, t.dim())
        else:
            assert _entries(spec) == w, (path, spec, w)
            assert len(spec) in (0, groups[path].dim())
        # spec_for_path at the reference's rank gives its spec too
        assert _entries(t_params.spec_for_path(
            path, len(jshape[path]), _rules(arch, fsdp, t_params))) == w


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "moonshot-v1-16b-a3b"])
def test_opt_state_specs_equal_reference(arch, optimizer):
    """adamw's m / v mirror the params (a stack one spec a layer);
    adafactor's stacked slots: ``vr`` drops the last dim, ``vc`` the
    second-to-last (``test_opt_state_specs_adafactor_reduced_dims``)."""
    from repro.train.optimizer import make_optimizer as j_opt
    from repro_torch.train.optimizer import make_optimizer as t_opt
    jp, model = _lm_pair(arch)
    rules_j, rules_t = (j_params.lm_param_rules("data"),
                        t_params.lm_param_rules("data"))
    j_specs = j_params.param_specs(jp, rules_j)
    jo = jax.eval_shape(j_opt(optimizer, 1e-3).init, jp)
    want = j_params.opt_state_specs(jo, j_specs, optimizer)
    t_specs = t_params.param_specs(model, rules_t)
    state = t_opt(optimizer, 1e-3).init(model)
    got = t_params.opt_state_specs(state, t_specs, optimizer)
    assert got["step"] == P() and _entries(want["step"]) == ()
    if optimizer == "adamw":
        assert got["m"] is t_specs and got["v"] is t_specs
        return
    flat = {}
    for path, leaf in tree_paths(jo["slots"]):
        flat[path] = leaf
    for path, slot in got["slots"].items():
        node = want["slots"]
        for part in path.split("/"):
            node = node[part]
        assert set(slot) == set(node), path
        for key, spec in slot.items():
            assert _entries(spec) == _entries(node[key]), (path, key)
            assert tuple(state["slots"][path][key].shape) == \
                tuple(flat[f"{path}/{key}"].shape)
    w1 = got["slots"]["moe_layers/moe/w1"]
    assert w1["vr"] == P(None, "model", "data")
    assert w1["vc"] == P(None, "model", None)


@pytest.mark.parametrize("arch,rules", [
    ("dimenet", "gnn_param_rules"), ("dlrm-rm2", "recsys_param_rules"),
    ("wide-deep", "recsys_param_rules")])
def test_family_param_specs_equal_reference(arch, rules):
    if arch == "dimenet":
        from repro.models.gnn.dimenet import init_dimenet as j_init
        from repro_torch.models.gnn.dimenet import init_dimenet as t_init
    else:
        from repro.models.recsys.models import init_recsys as j_init
        from repro_torch.models.recsys.models import init_recsys as t_init
    jp = jax.eval_shape(lambda k: j_init(k, j_smoke(arch)),
                        jax.random.PRNGKey(0))
    want = _flat_specs(j_params.param_specs(
        jp, getattr(j_params, rules)(None)))
    got = t_params.param_specs(t_init(get_smoke_config(arch), device="cpu"),
                               getattr(t_params, rules)(None))
    assert set(got) == set(want)
    for path, spec in got.items():
        w = _entries(want[path])
        if isinstance(spec, list):
            assert all(_entries(s) == w[1:] for s in spec), path
        else:
            assert _entries(spec) == w, path


def test_partition_spec_entries():
    assert P("data", None, ("pod", "data")) == ("data", None, ("pod", "data"))
    assert repr(P(None, "model")) == "P(None, 'model')"
    import copy
    import pickle
    s = P(("pod", "data"), "model")
    assert copy.deepcopy(s) == s and pickle.loads(pickle.dumps(s)) == s
    assert type(pickle.loads(pickle.dumps(s))) is P
    with pytest.raises(TypeError):
        P(3)


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("n_devices", [1, 3, 8])
@pytest.mark.parametrize("n_replicas,n_shards", [(1, 1), (2, 3), (4, 2)])
def test_serve_device_table_equals_reference(monkeypatch, n_devices,
                                             n_replicas, n_shards):
    """The same device count behind both: cell (r, s) on the same device
    index (round-robin tiling)."""
    devs = [torch.device("cuda", i) for i in range(n_devices)]
    monkeypatch.setattr(t_mesh, "_local_devices", lambda device: devs)
    monkeypatch.setattr(j_mesh.jax, "devices",
                        lambda *a: list(range(n_devices)))
    got = t_mesh.serve_device_table(n_replicas, n_shards)
    want = j_mesh.serve_device_table(n_replicas, n_shards)
    assert [[d.index for d in row] for row in got] == want


def test_serve_device_table_on_the_cpu():
    assert t_mesh.serve_device_table(2, 3, "cpu") == \
        [[torch.device("cpu")] * 3] * 2
    with pytest.raises(ValueError):
        t_mesh.serve_device_table(0, 1, "cpu")


def test_distinct_row_equals_reference():
    class Dev:
        def __init__(self, i):
            self.id = i
    for row in ([0], [0, 1, 2], [0, 1, 0], [3, 3]):
        assert t_mesh.distinct_row([f"cuda:{i}" for i in row]) == \
            j_mesh.distinct_row([Dev(i) for i in row])


def test_serve_and_shard_grids():
    grid = t_mesh.make_serve_mesh(1, 1, "cpu")
    assert grid.mesh_dim_names == ("replica", "shard")
    assert grid.shape == (1, 1) and grid.devices == ((torch.device("cpu"),),)
    with pytest.raises(ValueError):          # one CPU device
        t_mesh.make_serve_mesh(2, 1, "cpu")
    row = t_mesh.make_shard_mesh(["cpu", "cpu"])
    assert row.mesh_dim_names == ("shard",) and row.shape == (2,)
    assert t_mesh.axis_size(row, "shard") == 2


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(multi_pod):
    """(16, 16) and (2, 16, 16) over the fake process group; the data
    axes as the reference names them."""
    n = 512 if multi_pod else 256
    with t_mesh.fake_process_group(n):
        mesh = t_mesh.make_production_mesh(multi_pod=multi_pod,
                                           device="cpu")
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))

        class JMesh:
            axis_names = mesh.mesh_dim_names
        assert t_mesh.batch_axes(mesh) == j_mesh.batch_axes(JMesh)
        assert t_mesh.fsdp_axes(mesh) == j_mesh.fsdp_axes(JMesh)
        assert t_mesh.axis_size(mesh, "model") == 16
        host = t_mesh.make_host_mesh("cpu")
        assert tuple(host.shape) == (n,) and host.mesh_dim_names == ("data",)
    assert not dist.is_initialized()


def test_process_group_opens_and_closes():
    assert not dist.is_initialized()
    with t_mesh.process_group("cpu") as dev:
        assert dev == torch.device("cpu") and dist.get_world_size() == 1
        with pytest.raises(RuntimeError):
            with t_mesh.process_group("cpu"):
                pass
        with pytest.raises(ValueError):      # 4 ranks on a 1-rank group
            t_mesh.make_mesh((2, 2), ("data", "model"), "cpu")
        mesh = t_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):        # no group: no mesh
        t_mesh.make_mesh((1,), ("data",), "cpu")
    with pytest.raises(ValueError):          # several ranks need a store
        with t_mesh.process_group("cpu", world_size=2):
            pass
    assert not dist.is_initialized()


# --------------------------------------------------------------- constrain
def test_constrain_noop_without_context():
    x = torch.ones(4, 4)
    assert t_api.constrain(x, "batch", None) is x
    assert t_api.logical_spec("batch", None) == P()


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    with t_mesh.fake_process_group(512):
        mesh = t_mesh.make_production_mesh(multi_pod=True, device="cpu")
        pl = t_api.placements(P(("pod", "data"), None, "model"), mesh)
        assert pl == (Shard(0), Shard(0), Shard(2))
        assert t_api.placements(P(), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError):      # not in the mesh's order
            t_api.placements(P(("data", "pod")), mesh)
        with pytest.raises(ValueError):      # one axis, two dims
            t_api.placements(P("data", "data"), mesh)
        with pytest.raises(ValueError):
            t_api.placements(P("shard"), mesh)


def test_constrain_applies_in_context():
    """Under a context a tensor comes back as a DTensor of the rules'
    placements (one rank: the local tensor is the whole); the context
    is thread-local and restored on exit."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with t_mesh.process_group("cpu"):
        mesh = t_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
        x = torch.arange(24.0).reshape(4, 6)
        with t_api.mesh_context(mesh, t_api.lm_rules("data")) as ctx:
            assert t_api.current_ctx() is ctx
            assert t_api.logical_spec("batch", "heads", None) == \
                P("data", "model", None)
            y = t_api.constrain(x, "batch", "ff")
            assert isinstance(y, DTensor)
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert torch.equal(y.full_tensor(), x)
            z = t_api.constrain(y, None, None)
            assert tuple(z.placements) == (Replicate(), Replicate())
            with pytest.raises(ValueError):
                t_api.constrain(x, "batch")
        assert t_api.current_ctx() is None
        grid = t_mesh.make_shard_mesh(["cpu"])
        with t_api.mesh_context(grid, t_api.serve_rules()):
            assert t_api.logical_spec("docs", None) == P("shard", None)
            with pytest.raises(TypeError):   # a grid holds no DTensor
                t_api.constrain(x, "docs", None)
