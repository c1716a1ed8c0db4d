"""Parameter specs per architecture family (``src/repro/sharding/params.py``).

Megatron-style tensor parallelism + ZeRO/FSDP weight sharding:

  * column-parallel weights (wq/wk/wv, mlp w1/w3, lm_head): output dim on
    ``model``, input dim on the FSDP axis (``data``; + ``pod`` multi-pod).
  * row-parallel weights (wo, mlp w2): input dim on ``model``.
  * MoE experts [E, d, f]: E on ``model`` (EP == TP axis), d on FSDP.
  * embeddings/lm_head: vocab dim on ``model``.
  * norms/biases: replicated (tiny).
  * recsys tables [F, V, D]: V row-sharded on ``model``.
  * optimizer slots inherit the param's spec (adamw m/v) or the reduced
    spec with the averaged dim dropped (adafactor vr/vc).

A rule matches the reference's path of a parameter (``train/params.py``
``jax_path``: ``moe_layers/moe/w1``, never the ``nn.Module`` name) and
gives its trailing dims' spec, padded with leading ``None``s to the
tensor's rank. The reference stacks a trunk's layers on a leading axis;
the port holds each layer's tensor apart, so a port tensor's spec is the
reference's with the stacked leading ``None`` dropped: ``param_specs``
gives a stack's group one spec a layer. Adafactor's slots are stacked
in the port as in the reference (one factored slot over all layers), so
their specs are the reference's, the layer axis included.

``to_placements`` is the reference's ``to_shardings``: a tree of specs
to the same tree of DTensor placements over a mesh;
``checkpoint_placements`` the flat path -> placements dict a
checkpoint's restore lays its arrays out by (a stack stacked, as the
checkpoint holds it); ``distribute_meta``
lays a tree of ``meta`` tensors out as ``meta`` DTensors by those
placements, each holding one rank's shard (the dry run's arguments:
nothing allocates).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

from torch import nn

from repro_torch.sharding.api import P, placements
from repro_torch.train.params import jax_path, param_groups

Axis = Optional[object]


def _pad(spec_tail: Tuple, rank: int) -> P:
    pad = rank - len(spec_tail)
    if pad < 0:
        raise ValueError(f"spec {spec_tail} longer than rank {rank}")
    return P(*([None] * pad + list(spec_tail)))


def lm_param_rules(fsdp: Axis, model: str = "model"):
    """Ordered (regex on path suffix, trailing-dims spec) rules."""
    return [
        (r"attn/wq/w$", (fsdp, model)),
        (r"attn/wk/w$", (fsdp, model)),
        (r"attn/wv/w$", (fsdp, model)),
        (r"attn/wo/w$", (model, fsdp)),
        (r"attn/w[qkv]/b$", (model,)),
        (r"attn/wo/b$", (None,)),
        (r"(q|k)_norm/scale$", (None,)),
        (r"mlp/w[13]/w$", (fsdp, model)),
        (r"mlp/w2/w$", (model, fsdp)),
        (r"mlp/w[13]/b$", (model,)),
        (r"mlp/w2/b$", (None,)),
        (r"moe/router/w$", (None, None)),
        (r"moe/w[13]$", (model, fsdp, None)),
        (r"moe/w2$", (model, None, fsdp)),
        (r"moe/shared_w[13]/w$", (fsdp, model)),
        (r"moe/shared_w2/w$", (model, fsdp)),
        (r"embed/table$", (model, fsdp)),
        (r"pos_embed/table$", (None, None)),
        (r"lm_head/w$", (fsdp, model)),
        (r"lm_head/b$", (model,)),
        (r"norm/scale$", (None,)),
        (r"norm/bias$", (None,)),
        (r"proj/w$", (None, None)),      # ColBERT head: tiny, replicated
        (r"proj/b$", (None,)),
    ]


def gnn_param_rules(fsdp: Axis, model: str = "model"):
    # DimeNet params are ~1M: replicate everything.
    return [(r".*", ())]


def recsys_param_rules(fsdp: Axis, model: str = "model"):
    return [
        (r"tables$", (None, model, None)),   # [F, V(model), D]
        (r"wide$", (None, model, None)),
        (r".*", ()),                         # MLPs tiny: replicated
    ]


def spec_for_path(path: str, rank: int, rules) -> P:
    for pat, tail in rules:
        if re.search(pat, path):
            return _pad(tuple(tail), rank)
    return P()                               # replicated fallback


def param_specs(params, rules) -> Dict[str, object]:
    """A module or its groups (``train/params.py``) -> specs of the same
    shape: path -> spec, or path -> [spec per layer] for a stack."""
    out = {}
    for path, v in param_groups(params).items():
        if isinstance(v, (list, tuple)):
            out[path] = [spec_for_path(path, t.dim(), rules) for t in v]
        else:
            out[path] = spec_for_path(path, v.dim(), rules)
    return out


def _stacked_spec(spec) -> P:
    """A group's spec as the reference's stacked leaf has it: a stack's
    per-layer spec with the layer axis (``None``) in front; a replicated
    fallback ``P()`` stays ``P()``."""
    if not isinstance(spec, (list, tuple)) or isinstance(spec, P):
        return spec
    first = spec[0]
    return P(None, *first) if len(first) else P()


def opt_state_specs(opt_state, p_specs, optimizer: str):
    """Specs for the optimizer state (``train/optimizer.py``'s) given the
    params' specs. adamw: m/v mirror the params (a stack one spec a
    layer); adafactor: a stacked slot's ``vr`` drops the last dim's axis,
    ``vc`` the second-to-last, an unfactored ``v`` keeps the param's;
    the step is replicated."""
    if optimizer == "adamw":
        return {"step": P(), "m": p_specs, "v": p_specs}

    def reduce_spec(spec: P, drop_last: bool) -> P:
        lst = list(spec)
        if not lst:
            return P()
        if drop_last:
            return P(*lst[:-1])
        return P(*(lst[:-2] + lst[-1:]))

    slots = {}
    for path, slot in opt_state["slots"].items():
        spec = _stacked_spec(p_specs[path])
        if "vr" in slot:
            slots[path] = {"vr": reduce_spec(spec, True),
                           "vc": reduce_spec(spec, False)}
        else:
            slots[path] = {"v": spec}
    return {"step": P(), "slots": slots}


def distribute_params(module: nn.Module, mesh, rules,
                      prefix: str = "") -> nn.Module:
    """Every parameter of ``module`` (the same values on every rank)
    replaced, in place, by a ``DTensor`` parameter laid out by its
    spec: ``spec_for_path(prefix + jax_path(name))``. ``prefix`` places
    a sub-module's paths in its trunk's tree (``"moe/"`` for a lone
    ``MoE``)."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(module.named_parameters()):
        path, _ = jax_path(name)
        spec = spec_for_path(prefix + path, p.dim(), rules)
        owner = module.get_submodule(name.rpartition(".")[0])
        setattr(owner, name.rpartition(".")[2], nn.Parameter(
            distribute_tensor(p.detach(), mesh, placements(spec, mesh)),
            requires_grad=p.requires_grad))
    return module


def to_placements(mesh, specs):
    """A tree of specs (dicts, lists; a ``P`` at each leaf, or None) ->
    the same tree of DTensor placements over ``mesh`` (``placements`` of
    each spec): the reference's ``to_shardings``."""
    if specs is None or isinstance(specs, P):
        return None if specs is None else placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: to_placements(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(to_placements(mesh, v) for v in specs)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _flat_specs(specs, prefix: str, out: Dict[str, P]) -> None:
    if isinstance(specs, dict):
        for k, v in specs.items():
            _flat_specs(v, f"{prefix}{k}/", out)
    else:
        out[prefix[:-1]] = _stacked_spec(specs)


def checkpoint_placements(mesh, p_specs, o_specs=None) -> Dict[str, tuple]:
    """The specs of a trainer's parameters (``param_specs``) and of its
    optimizer state (``opt_state_specs``; its host ``step`` left out) ->
    {path in the checkpoint's tree: placements over ``mesh``}, a stack's
    per-layer spec with the layer axis in front, as the checkpoint
    stacks it: ``CheckpointManager.restore``'s ``placements``."""
    flat: Dict[str, P] = {}
    _flat_specs(p_specs, "params/", flat)
    if o_specs is not None:
        _flat_specs({k: v for k, v in o_specs.items() if k != "step"},
                    "opt_state/", flat)
    return {path: placements(spec, mesh) for path, spec in flat.items()}


def distribute_meta(tree, mesh, place):
    """A tree of ``meta`` tensors (global shapes) and its placements (the
    matching tree ``to_placements`` gives) -> the same tree of ``meta``
    DTensors over ``mesh``, each holding this rank's shard (``Shard``
    splits as ``torch.chunk`` does: rank 0 holds the largest, an uneven
    split's padding included). Host values (an optimizer's step) pass
    through."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    if isinstance(tree, dict):
        return {k: distribute_meta(v, mesh, place[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_meta(v, mesh, p)
                          for v, p in zip(tree, place))
    if not isinstance(tree, torch.Tensor):
        return tree
    if not tree.is_meta:
        raise ValueError("distribute_meta lays out meta tensors only")
    local, _ = compute_local_shape_and_global_offset(tree.shape, mesh, place)
    return DTensor.from_local(
        torch.empty(local, dtype=tree.dtype, device="meta"), mesh, place,
        run_check=False, shape=tree.shape, stride=tree.stride())
