"""Shared by ``test_torch_dryrun.py`` and ``test_torch_roofline.py``:
one cell's dry run (``repro_torch.launch.dryrun.run_cell``) held to the
reference's ``build_cell`` leaves and specs over the (16, 16) production
axis sizes (arithmetic: nothing is lowered), and to no real allocation.
"""
import math
import resource

import jax
import numpy as np
from jax.sharding import PartitionSpec as JP

from repro.launch import input_specs as j_specs
from repro.models.layers import tree_paths
from repro_torch.launch import dryrun

AXES = {"data": 16, "model": 16}          # the (16, 16) production mesh
# leaves the reference has and the port's arguments do not: ColBERT's
# unused lm_head (``test_torch_input_specs.py``), and the optimizer's
# step, a host int in the port (no device bytes), an int32 scalar there
NOT_PORTED = {"colbertv2": {"params/trunk/lm_head/w"}}
GB = 2 ** 30


def _ref_spec_leaves(tree, prefix=""):
    if isinstance(tree, JP) or tree is None:
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_ref_spec_leaves(v, f"{prefix}{k}/"))
    return out


def reference_rank_bytes(arch, cell, layers, axes=AXES):
    """Per argument, rank 0's bytes of the reference's leaves split by
    its specs over ``axes`` (axis name -> size): each dim ceil(size /
    ranks it is split over), times the itemsize."""
    jb = j_specs.build_cell(arch, cell, jax.make_mesh((1, 1),
                                                      ("data", "model")),
                            layers_override=layers)
    names = dryrun._arg_names(jb.kind, len(jb.args))
    out = {}
    for name, args, specs in zip(names, jb.args, jb.in_specs):
        leaves = dict(tree_paths(args))
        spec_of = _ref_spec_leaves(specs)
        total = 0
        for path, leaf in leaves.items():
            if (f"{name}/{path}" in NOT_PORTED.get(arch, ())
                    or (name == "opt_state" and path == "step")):
                continue
            spec = tuple(spec_of[path] or ())
            local = 1
            for i, n in enumerate(leaf.shape):
                entry = spec[i] if i < len(spec) else None
                mesh_axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                local *= -(-n // math.prod(axes[a] for a in mesh_axes))
            total += local * np.dtype(leaf.dtype).itemsize
        out[name] = total
    return out


def check_cell(arch, cell, layers, stages=2):
    """Stages 1 to ``stages`` at ``layers``: per-rank argument bytes
    equal the reference's, the step ran, nothing real was allocated."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    r = dryrun.run_cell(arch, cell, layers_override=layers, stages=stages,
                        verbose=False)
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) * 1024
    want = reference_rank_bytes(arch, cell, layers)
    assert r["arg_bytes"] == want, (arch, cell, r["arg_bytes"], want)
    assert r["argument_size_in_bytes"] == sum(want.values())
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    g = r["global"]
    assert g["bytes_accessed"] > 0 and g["output_bytes"] > 0
    assert g["activation_peak_bytes"] > 0
    assert g["flops"] > 0 or arch == "fm"      # fm has no product
    assert r["even_split"]["flops"] == g["flops"] / 256
    # the trace's global activations alone would not fit this process
    assert grown < 2 * GB, grown
    return r
