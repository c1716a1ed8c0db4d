"""A module's parameters as the reference's parameter tree lays them out.

The reference keeps a trunk's layers stacked on a leading axis under
``dense_layers`` (and a MoE trunk's MoE blocks under ``moe_layers``);
the port keeps one module per layer (``layers.<i>``, ``moe_layers.<i>``).
Training works on *groups*, one per leaf of the reference's tree, keyed
by its path in ``tree_paths``' syntax (``trunk/dense_layers/attn/wq/w``)
in the reference's leaf order (sorted keys): a tensor for a parameter of
its own, a list of the L per-layer tensors for a stack. Gradients,
AdamW's moments and Adafactor's slots take the same keys, so the
optimizers treat a stack as the reference does (one clip, one factored
slot over all L layers) and a checkpoint holds the reference's tree.

  * ``jax_path`` / ``group`` / ``param_groups``: module names to groups;
  * ``tree_map`` / ``leaves``: over groups (and slot dicts);
  * ``value_and_grad``: a loss and its gradient per group, through
    autograd; ``microbatch_value_and_grad`` over slices of a batch;
  * ``to_tree`` / ``load_tree``: groups to the reference's nested tree
    of host arrays (stacks stacked) and back, in place; a tensor laid
    out over a mesh (a ``DTensor``) is gathered one leaf at a time on
    the way out (kept by the rank that writes it, dropped at once by
    the others), and comes back from a tree laid out as it is
    (``CheckpointManager.restore(placements=...)``), each rank copying
    its own shard;
  * ``from_tree``: the reference's tree to a module's state dict
    (``params_from_jax`` of every model);
  * ``tree_paths``: the reference's ``a/b/0/c`` flattening.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


# the reference's stacks -> the port's per-layer module lists
STACKS = {"dense_layers": "layers", "moe_layers": "moe_layers",
          "blocks": "blocks"}
_STACK_OF = {v: k for k, v in STACKS.items()}


def jax_path(name: str) -> Tuple[str, Optional[int]]:
    """A module parameter's name -> (its path in the reference's tree,
    its layer index in a stack or None): ``trunk.layers.3.attn.wq.w`` ->
    (``trunk/dense_layers/attn/wq/w``, 3), ``moe_layers.1.moe.w1`` ->
    (``moe_layers/moe/w1``, 1)."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part in _STACK_OF and parts[i + 1].isdigit():
            return "/".join(parts[:i] + [_STACK_OF[part]] + parts[i + 2:]), \
                int(parts[i + 1])
    return "/".join(parts), None


def group(named: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    """(name, value) pairs -> groups: path -> value, or path -> [value per
    layer] for a stack, paths sorted."""
    single: Dict[str, Any] = {}
    stacks: Dict[str, Dict[int, Any]] = {}
    for name, value in named:
        path, i = jax_path(name)
        if i is None:
            single[path] = value
        else:
            stacks.setdefault(path, {})[i] = value
    for path, rows in stacks.items():
        if sorted(rows) != list(range(len(rows))):
            raise ValueError(f"{path}: layers {sorted(rows)} are not 0..L-1")
        single[path] = [rows[i] for i in range(len(rows))]
    return {p: single[p] for p in sorted(single)}


def param_groups(params) -> Dict[str, Any]:
    """An ``nn.Module`` (grouped by ``jax_path``) or an already grouped
    dict (returned sorted) -> groups."""
    if isinstance(params, nn.Module):
        return group(params.named_parameters())
    return {p: params[p] for p in sorted(params)}


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of groups of one structure (dicts, lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _unflatten_like(tree, flat: List):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def _as_param(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A gradient laid out as its parameter: over a mesh the reduction
    over the data axes (a partial sum reduce-scattered to an FSDP shard,
    all-reduced to a replica), as the reference's out shardings give it;
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if (isinstance(p, DTensor) and isinstance(g, DTensor)
            and tuple(g.placements) != tuple(p.placements)):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(loss_fn: Callable, model, *args):
    """``loss_fn(model, *args) -> (loss, metrics)`` and the gradient of
    the loss in ``model``'s groups (a parameter the loss does not reach
    gets zeros, as the reference's ``jax.grad`` gives) -> (loss, metrics,
    grads), loss and metrics detached; a parameter laid out over a mesh
    gets its gradient in its own layout (``_as_param``)."""
    groups = param_groups(model)
    params = leaves(groups)
    with torch.enable_grad():
        loss, metrics = loss_fn(model, *args)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _as_param(p, g)
             for p, g in zip(params, grads)]
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten_like(groups, grads)


def microbatch_value_and_grad(loss_fn: Callable, model, batch: Dict,
                              n_micro: int = 1,
                              acc_dtype: torch.dtype = torch.float32,
                              place: Optional[Callable] = None):
    """``value_and_grad`` over ``n_micro`` consecutive slices of the
    batch's leading axis (the reference's reshape to [n, B / n, ...]):
    the mean loss, the last slice's metrics, and the gradients summed in
    ``acc_dtype`` and divided by ``n_micro``. At 1, one call, its
    gradients as autograd gives them. ``place``: a slice of the batch
    (as sliced here, on the host under a mesh) -> the model's input."""
    place = place or (lambda part: part)
    if n_micro == 1:
        return value_and_grad(loss_fn, model, place(batch))
    mb = next(iter(batch.values())).shape[0] // n_micro
    loss, grads = 0.0, None
    for i in range(n_micro):
        part = place({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
        li, metrics, g = value_and_grad(loss_fn, model, part)
        g = tree_map(lambda x: x.to(acc_dtype), g)
        grads = g if grads is None else tree_map(torch.Tensor.add_, grads, g)
        loss = loss + li.float()
    return (loss / n_micro, metrics,
            tree_map(lambda g: g.div_(n_micro), grads))


def is_dtensor(t) -> bool:
    """True for a tensor laid out over a mesh."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def full_value(t):
    """A ``DTensor``'s full value, gathered on every rank of its mesh (a
    plain tensor as it is)."""
    return t.full_tensor() if is_dtensor(t) else t


def host(t, keep: bool = True) -> Optional[np.ndarray]:
    """A host numpy copy (never a view of a tensor updated in place); a
    ``DTensor``'s full array, gathered on every rank of its mesh.
    ``keep=False``: the gather alone (a rank that writes nothing takes
    part in it), its result dropped at once -> None."""
    if torch.is_tensor(t):
        t = full_value(t.detach())
        if not keep:
            return None
        return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    return np.array(t) if keep else None


def _host_leaf(v, keep: bool):
    if isinstance(v, dict):
        return {k: _host_leaf(x, keep) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        if not keep:
            for x in v:
                host(x, keep=False)
            return None
        # one host copy: each layer straight into its row of the stack
        out = torch.empty((len(v),) + tuple(v[0].shape), dtype=v[0].dtype)
        for i, x in enumerate(v):
            out[i].copy_(full_value(x.detach()))
        return out.numpy()
    return host(v, keep)


def listify(node):
    """Dict nodes keyed 0..n-1 -> lists (the reference's MLP lists)."""
    if not isinstance(node, dict):
        return node
    out = {k: listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and sorted(
            out, key=int) == [str(i) for i in range(len(out))]:
        return [out[str(i)] for i in range(len(out))]
    return out


def to_tree(groups: Dict[str, Any], keep: bool = True) -> Dict[str, Any]:
    """Groups -> the reference's nested tree of host arrays: each path
    split on ``/``, a stack stacked on axis 0, a slot dict kept under its
    path, a node keyed 0..n-1 a list. ``keep=False`` (a rank of a mesh
    that writes nothing): every ``DTensor`` leaf still gathered, one at
    a time, and dropped; the tree's leaves None."""
    tree: Dict[str, Any] = {}
    for path, v in groups.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _host_leaf(v, keep)
    return listify(tree)


def from_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The reference's parameter tree -> a module's state (names under
    ``prefix``, numpy arrays): a stack of ``STACKS`` unstacked into its
    module list (``dense_layers`` -> ``layers.<i>``), a list's entries
    as ``<key>.<i>``, the rest flattened with ``.``."""
    state: Dict[str, np.ndarray] = {}

    def walk(node, name, index=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}{k}.", index)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{name}{i}.", index)
        else:
            a = np.asarray(node)
            state[name[:-1]] = a if index is None else a[index]

    for key, sub in tree.items():
        if key in STACKS and isinstance(sub, dict):
            n = np.asarray(tree_paths(sub)[0][1]).shape[0]
            for i in range(n):
                walk(sub, f"{prefix}{STACKS[key]}.{i}.", i)
        else:
            walk(sub, f"{prefix}{key}.")
    return state


def _copy_into(leaf, node, path: str) -> None:
    if isinstance(leaf, dict):
        for k, x in leaf.items():
            _copy_into(x, node[k], f"{path}/{k}")
        return
    if isinstance(leaf, (list, tuple)):
        # a laid-out stack's local rows are its layers' local shards
        rows = node.to_local() if is_dtensor(node) else np.asarray(node)
        if node.shape[0] != len(leaf):
            raise ValueError(f"{path}: {node.shape[0]} layers in the tree, "
                             f"{len(leaf)} in the module")
        for i, t in enumerate(leaf):
            _copy_into(t, rows[i], f"{path}/{i}")
        return
    if is_dtensor(node):
        if (tuple(node.shape) != tuple(leaf.shape) or not is_dtensor(leaf)
                or tuple(node.placements) != tuple(leaf.placements)):
            raise ValueError(f"{path}: {tuple(node.shape)} laid out as "
                             f"{tuple(node.placements)} in the tree, "
                             f"{tuple(leaf.shape)} as "
                             f"{getattr(leaf, 'placements', None)} here")
        node = node.to_local()
    # into a DTensor: this rank's shard (a laid-out tree's local values)
    dst = leaf.to_local() if is_dtensor(leaf) else leaf
    src = node if torch.is_tensor(node) else torch.as_tensor(np.asarray(node))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} in the tree, "
                         f"{tuple(dst.shape)} here")
    with torch.no_grad():
        dst.copy_(src)


def load_tree(groups: Dict[str, Any], tree) -> None:
    """Copy a reference-layout tree into groups in place (a stack's rows
    into its per-layer tensors). Paths of the tree that no group names
    (the ColBERT trunk's unused ``lm_head``) are ignored."""
    for path, leaf in groups.items():
        node = tree
        for p in path.split("/"):
            if isinstance(node, (list, tuple)) and p.isdigit() and int(
                    p) < len(node):
                node = node[int(p)]
            elif isinstance(node, dict) and p in node:
                node = node[p]
            else:
                raise KeyError(f"{path}: not in the tree")
        _copy_into(leaf, node, path)


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """('a/b/0/c', leaf) pairs of a nested dict / list tree, in the
    reference's order (dict keys sorted, lists by index; None is an empty
    subtree)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out.append((prefix[:-1], node))

    walk(tree, "")
    return out
