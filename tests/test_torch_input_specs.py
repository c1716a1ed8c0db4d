"""The cells' shape-only inputs (``repro_torch.launch.input_specs``)
against the JAX package's (``repro.launch.input_specs``).

Every (arch x cell) of ``ASSIGNED_ARCHS`` (40) plus ColBERT's two builds
on a one-rank (1, 1) ("data", "model") mesh, as
``tests/test_roofline.py::test_all_40_cells_build_structurally`` builds
the reference's, and:

* each argument tree pairs up with its spec tree (same dicts and lists,
  a ``P`` at every tensor, or at the optimizer's step, a host int);
* every leaf's shape and dtype equal the reference's ``build_cell``
  leaf on a (1, 1) mesh: a stack's list of L per-layer tensors against
  the reference's stacked [L, ...] leaf; the optimizer's step, a host
  int in the port, against the reference's int32 scalar by shape; the
  reference ColBERT's ``trunk/lm_head/w``, which its encoder never
  reads and the port's encoder lacks, is the one leaf left out;
* every spec equals the reference's (a stack's per-layer specs without
  the stacked leading ``None``), as do the rules and donated arguments;
* nothing allocates: every tensor and the model's parameters lie on the
  ``meta`` device (Kimi K2's train cell alone stands for ~4 TB).

The production meshes ((16, 16) and (2, 16, 16), over the fake process
group) build every cell too, with the reference's data axes in the
batch specs.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.launch import input_specs as j_specs
from repro.models.layers import tree_paths
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS
from repro_torch.launch import input_specs as t_specs
from repro_torch.launch.mesh import (fake_process_group, make_mesh,
                                     make_production_mesh, process_group)
from repro_torch.sharding.api import P

NOT_PORTED = {"colbertv2": {"trunk/lm_head/w"}}


def _flat(tree, prefix=""):
    """A port argument or spec tree -> {path: leaf}; a stack's list of
    per-layer leaves stays one entry (a list)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _flat_ref(tree, leaf_type=None):
    """A reference tree -> {path: leaf} (specs stop at ``PartitionSpec``)."""
    if leaf_type is None:
        return dict(tree_paths(tree))

    def walk(node, prefix):
        if isinstance(node, leaf_type) or node is None:
            return {prefix[:-1]: node}
        items = node.items() if isinstance(node, dict) else enumerate(node)
        out = {}
        for k, v in items:
            out.update(walk(v, f"{prefix}{k}/"))
        return out
    return walk(tree, "")


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _pairs(args, specs, where):
    """Same dicts / lists; a P at each tensor (or host int) leaf."""
    if isinstance(args, dict):
        assert isinstance(specs, dict) and set(args) == set(specs), where
        for k in args:
            _pairs(args[k], specs[k], f"{where}/{k}")
    elif isinstance(args, list):
        assert isinstance(specs, list) and len(specs) == len(args), where
        for a, s in zip(args, specs):
            _pairs(a, s, where)
    else:
        assert isinstance(specs, P), (where, specs)
        assert isinstance(args, (torch.Tensor, int)), where
        if isinstance(args, torch.Tensor):
            assert args.is_meta, where
            assert len(specs) in (0, args.dim()), (where, specs)


def _check_cell(arch, cell, t_mesh, j_mesh):
    b = t_specs.build_cell(arch, cell, t_mesh)
    jb = j_specs.build_cell(arch, cell, j_mesh)
    assert callable(b.fn) and (b.kind, b.note) == (jb.kind, jb.note)
    assert b.donate == jb.donate and b.rules == jb.rules
    assert all(p.is_meta for p in b.model.parameters())
    assert len(b.args) == len(b.in_specs) == len(jb.args)
    for i, (args, specs, jargs, jspecs) in enumerate(zip(
            b.args, b.in_specs, jb.args, jb.in_specs)):
        _pairs(args, specs, f"{arch}/{cell}/{i}")
        got, want = _flat(args), _flat_ref(jargs)
        gspec, wspec = _flat(specs), _flat_ref(jspecs, JP)
        skip = NOT_PORTED.get(arch, set()) if i == 0 else set()
        assert set(want) - set(got) == skip and set(got) <= set(want), \
            (arch, cell, i, set(want) ^ set(got))
        for path, leaf in got.items():
            w, ws = want[path], tuple(wspec[path])
            if isinstance(leaf, list):      # a stack: L per-layer tensors
                assert (len(leaf), *leaf[0].shape) == tuple(w.shape), path
                assert {_dtype(t) for t in leaf} == {np.dtype(w.dtype).name}
                assert ws[:1] in ((), (None,)), (path, ws)
                assert all(tuple(s) == ws[1:] for s in gspec[path]), path
            elif isinstance(leaf, int):     # the optimizer's step
                assert tuple(w.shape) == () and tuple(gspec[path]) == ws
            else:
                assert tuple(leaf.shape) == tuple(w.shape), (path, leaf.shape)
                assert _dtype(leaf) == np.dtype(w.dtype).name, path
                assert tuple(gspec[path]) == ws, (path, gspec[path], ws)
    return b


@pytest.fixture
def one_rank_mesh():
    with process_group("cpu"):
        yield make_mesh((1, 1), ("data", "model"), "cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cells_equal_reference_leaves(arch, one_rank_mesh):
    j_mesh = jax.make_mesh((1, 1), ("data", "model"))
    cells = t_specs.all_cells(arch)
    assert cells == j_specs.all_cells(arch)
    for cell in cells:
        _check_cell(arch, cell, one_rank_mesh, j_mesh)


def test_the_40_assigned_cells_and_colberts_build():
    n = sum(len(t_specs.all_cells(a)) for a in ASSIGNED_ARCHS)
    assert n == 40 and len(t_specs.all_cells("colbertv2")) == 2


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cells_on_the_production_mesh(multi_pod):
    """Over the fake process group: every cell builds; the batch specs
    name ("pod", "data") multi-pod; Kimi K2's train cell stands for its
    ~1T parameters and their optimizer state, none of it allocated."""
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        dp = ("pod", "data") if multi_pod else "data"
        for arch in ALL_ARCHS:
            for cell in t_specs.all_cells(arch):
                b = t_specs.build_cell(arch, cell, mesh)
                for i, (a, s) in enumerate(zip(b.args, b.in_specs)):
                    _pairs(a, s, f"{arch}/{cell}/{i}")
        b = t_specs.build_cell("kimi-k2-1t-a32b", "train_4k", mesh)
        assert b.in_specs[2]["tokens"] == P(dp, None)
        params = [t for v in b.args[0].values()
                  for t in (v if isinstance(v, list) else [v])]
        n = sum(t.numel() for t in params)
        assert n > 1.0e12 and all(t.is_meta for t in params)
        w1 = b.in_specs[0]["moe_layers/moe/w1"][0]
        assert w1 == P("model", dp, None)
        b = t_specs.build_cell("dimenet", "ogb_products", mesh)
        assert b.args[2]["t_in"].shape[0] > 4.9e8 and b.args[2]["t_in"].is_meta


def test_build_cell_overrides():
    """``layers_override`` cuts the stacks; ``cfg_overrides`` reaches the
    specs (no FSDP axis) and qwen2.5-14b's sequence-sharded rules hold;
    ``unroll`` builds (the reference's analysis mode)."""
    with fake_process_group(256):
        mesh = make_production_mesh(device="cpu")
        b = t_specs.build_cell("qwen3-0.6b", "prefill_32k", mesh, unroll=True,
                               layers_override=2)
        assert len(b.args[0]["dense_layers/attn/wq/w"]) == 2
        b2 = t_specs.build_cell("qwen2.5-14b", "train_4k", mesh,
                                cfg_overrides={"fsdp_params": False},
                                rules_overrides={"seq": "model"})
        assert b2.rules["seq"] == "model"
        assert b2.in_specs[0]["dense_layers/attn/wq/w"][0] == P(None, "model")
        assert b2.rules["qseq"] == "model" and b2.rules["heads"] is None
