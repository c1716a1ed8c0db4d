"""Shape-only stand-ins and specs for every (arch x shape) cell
(``src/repro/launch/input_specs.py``).

``build_cell(arch, cell, mesh)`` returns a ``CellBuild``:
  fn            — the step (``launch/steps.py``'s builders), built for
                  the ``meta`` device
  model         — the step's model on the ``meta`` device (the steps take
                  the model in place of the reference's parameter tree)
  args          — tuple of argument trees of ``meta`` tensors: the
                  model's parameter groups (``train/params.py``: path ->
                  tensor, or a stack's list of per-layer tensors), the
                  optimizer state of train cells, the batch
  in_specs      — matching trees of ``PartitionSpec``: a stack's group
                  one spec a layer (the reference's without its stacked
                  leading ``None``)
  out_specs     — the reference's, or None
  rules         — the logical-axis rules to activate (``mesh_context``)
  note, donate  — as the reference's.

Everything here is shapes and dtypes on the ``meta`` device: nothing
allocates, which is what lets a 1T-parameter config (Kimi K2, 2 TB in
bf16) and ``ogb_products``' ~495M triplets be laid out on any machine.
``mesh`` is read for its axis names only (a ``DeviceMesh`` of the
production shape over ``launch/mesh.fake_process_group``, or any
``DeviceMesh`` / ``DeviceGrid``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (ColbertConfig, DimeNetConfig,
                                      RecsysConfig, ShapeCell,
                                      TransformerConfig, shapes_for)
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import batch_axes as mesh_batch_axes
from repro_torch.launch.mesh import fsdp_axes as mesh_fsdp_axes
from repro_torch.models.layers import dt
from repro_torch.sharding import api as rules_api
from repro_torch.sharding.api import P
from repro_torch.sharding.params import (gnn_param_rules, lm_param_rules,
                                         opt_state_specs, param_specs,
                                         recsys_param_rules)
from repro_torch.train.params import param_groups

F32, I32, BOOL = torch.float32, torch.int32, torch.bool
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclass
class CellBuild:
    arch: str
    cell: str
    kind: str
    fn: Callable
    model: torch.nn.Module
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Optional[Any]
    rules: Dict[str, Any]
    note: str = ""
    donate: Tuple[int, ...] = ()   # donated arg indices (in-place buffers)


def _params(model, rules):
    groups = param_groups(model)
    return groups, param_specs(groups, rules)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_cell(cfg: TransformerConfig, cell: ShapeCell, mesh,
             arch: str) -> CellBuild:
    from repro_torch.models.transformer import init_transformer
    dp = mesh_batch_axes(mesh)
    fsdp = mesh_fsdp_axes(mesh) if cfg.fsdp_params else None
    model = init_transformer(cfg, device=META)
    p_struct, p_specs = _params(model, lm_param_rules(fsdp))
    seq = cell.dim("seq_len")
    gb = cell.dim("global_batch")

    if cell.kind == "train":
        step, opt = S.make_lm_train_step(cfg, device=META)
        o_struct = opt.init(p_struct)
        o_specs = opt_state_specs(o_struct, p_specs, cfg.optimizer)
        batch = {"tokens": sds((gb, seq), I32),
                 "labels": sds((gb, seq), I32)}
        b_specs = {"tokens": P(dp, None), "labels": P(dp, None)}
        return CellBuild(
            arch, cell.name, cell.kind, step, model,
            (p_struct, o_struct, batch), (p_specs, o_specs, b_specs),
            (p_specs, o_specs, None),
            rules_api.lm_rules(dp, attn_shard=cfg.attn_shard),
            donate=(0, 1))

    if cell.kind == "prefill":
        if cfg.unroll_scans and seq // cfg.attn_chunk > 8:
            # the reference's analysis mode: larger attention chunks
            # (identical matmul volume, coarser tiling)
            cfg = dataclasses.replace(cfg, attn_chunk=seq // 8)
        step = S.make_lm_prefill_step(cfg, device=META)
        batch = {"tokens": sds((gb, seq), I32)}
        b_specs = {"tokens": P(dp, None)}
        return CellBuild(
            arch, cell.name, cell.kind, step, model, (p_struct, batch),
            (p_specs, b_specs), None,
            rules_api.lm_rules(dp, attn_shard=cfg.attn_shard))

    # decode cells: one token against a seq_len cache
    if cell.kind != "decode":
        raise ValueError(f"{arch}: unknown cell kind {cell.kind!r}")
    step = S.make_lm_decode_step(cfg, device=META)
    cdt = dt(cfg.dtype)
    L, KV, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    cache = {"k": sds((L, gb, seq, KV, dh), cdt),
             "v": sds((L, gb, seq, KV, dh), cdt)}
    batch = {"token": sds((gb, 1), I32), "pos": sds((), I32)}
    if gb == 1:
        rules = rules_api.lm_long_decode_rules(dp)
        kv_spec = P(None, None, rules["kvseq"], None, None)
    else:
        rules = rules_api.lm_decode_rules(dp)
        kv_spec = P(None, dp, "model", None, None)
    c_specs = {"k": kv_spec, "v": kv_spec}
    b_specs = {"token": P(None if gb == 1 else dp, None), "pos": P()}
    return CellBuild(
        arch, cell.name, cell.kind, step, model,
        (p_struct, cache, batch), (p_specs, c_specs, b_specs), None, rules,
        donate=(1,))


# ---------------------------------------------------------------------------
# GNN cells (DimeNet)
# ---------------------------------------------------------------------------
GNN_CELL_META = {
    # cell -> (d_feat or None->atom types, n_classes/targets, task, graphs)
    "full_graph_sm": (1433, 7, "node", 1),
    "minibatch_lg": (602, 41, "node", 1),
    "ogb_products": (100, 47, "node", 1),
    "molecule": (None, 1, "graph", 128),
}


def _rup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _gnn_counts(cell: ShapeCell, cap: int):
    if cell.name == "minibatch_lg":
        b = cell.dim("batch_nodes")
        f0, f1 = cell.dim("fanout0"), cell.dim("fanout1")
        n = b + b * f0 + b * f0 * f1
        e = b * f0 + b * f0 * f1
    elif cell.name == "molecule":
        n = cell.dim("n_nodes") * cell.dim("batch")
        e = cell.dim("n_edges") * cell.dim("batch")
    else:
        n, e = cell.dim("n_nodes"), cell.dim("n_edges")
    # pad to shard-divisible sizes (masked rows; nodes shard 16-way on
    # data, edges/triplets up to 512-way on pod x data x model)
    n, e = _rup(n, 32), _rup(e, 512)
    return n, e, e * cap


def _gnn_cell(cfg: DimeNetConfig, cell: ShapeCell, mesh,
              arch: str) -> CellBuild:
    from repro_torch.models.gnn.dimenet import init_dimenet
    dp = mesh_batch_axes(mesh)
    d_feat, n_cls, task, n_graphs = GNN_CELL_META[cell.name]
    cfg = dataclasses.replace(cfg, d_feat_in=d_feat or 0, n_targets=n_cls)
    N, E, T = _gnn_counts(cell, cfg.triplet_cap)

    model = init_dimenet(cfg, device=META)
    p_struct, p_specs = _params(model, gnn_param_rules(None))
    step, opt = S.make_gnn_train_step(cfg, task, n_graphs, device=META)
    o_struct = opt.init(p_struct)
    o_specs = opt_state_specs(o_struct, p_specs, cfg.optimizer)

    rules = rules_api.gnn_rules(dp)
    ep = rules["edges"]
    batch = {
        "pos": sds((N, 3), F32),
        "edge_index": sds((2, E), I32),
        "t_in": sds((T,), I32), "t_out": sds((T,), I32),
        "t_mask": sds((T,), BOOL),
        "node_mask": sds((N,), BOOL), "edge_mask": sds((E,), BOOL),
    }
    b_specs = {
        "pos": P(dp, None), "edge_index": P(None, ep),
        "t_in": P(ep), "t_out": P(ep), "t_mask": P(ep),
        "node_mask": P(dp), "edge_mask": P(ep),
    }
    if d_feat is None:
        batch["z"] = sds((N,), I32)
        b_specs["z"] = P(dp)
        batch["graph_ids"] = sds((N,), I32)
        b_specs["graph_ids"] = P(dp)
        batch["targets"] = sds((n_graphs, cfg.n_targets), F32)
        b_specs["targets"] = P(None, None)
    else:
        batch["feat"] = sds((N, d_feat), F32)
        b_specs["feat"] = P(dp, None)
        batch["targets"] = sds((N,), I32)
        b_specs["targets"] = P(dp)
    return CellBuild(
        arch, cell.name, "train", step, model,
        (p_struct, o_struct, batch), (p_specs, o_specs, b_specs),
        (p_specs, o_specs, None), rules,
        note=f"N={N} E={E} T={T} task={task}", donate=(0, 1))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------
def _recsys_cell(cfg: RecsysConfig, cell: ShapeCell, mesh,
                 arch: str) -> CellBuild:
    from repro_torch.models.recsys.models import init_recsys
    dp = mesh_batch_axes(mesh)
    model = init_recsys(cfg, device=META)
    p_struct, p_specs = _params(model, recsys_param_rules(None))
    rules = rules_api.recsys_rules(dp)
    B = cell.dim("batch")

    def mk_batch(bsz, with_label):
        b = {"sparse_ids": sds((bsz, cfg.n_sparse, cfg.multi_hot), I32)}
        s = {"sparse_ids": P(dp, None, None)}
        if cfg.n_dense:
            b["dense"] = sds((bsz, cfg.n_dense), F32)
            s["dense"] = P(dp, None)
        if with_label:
            b["label"] = sds((bsz,), F32)
            s["label"] = P(dp)
        return b, s

    if cell.kind == "train":
        step, opt = S.make_recsys_train_step(cfg, device=META)
        o_struct = opt.init(p_struct)
        o_specs = opt_state_specs(o_struct, p_specs, cfg.optimizer)
        batch, b_specs = mk_batch(B, True)
        return CellBuild(arch, cell.name, "train", step, model,
                         (p_struct, o_struct, batch),
                         (p_specs, o_specs, b_specs),
                         (p_specs, o_specs, None), rules, donate=(0, 1))

    if cell.name == "retrieval_cand":
        C = cell.dim("n_candidates")
        # batch=1 request: batch axis replicated, candidate axis data-sharded
        rules = {**rules, "batch": None}
        step = S.make_recsys_retrieval_step(cfg, device=META)
        batch, b_specs = mk_batch(B, False)
        batch["candidates"] = sds((C, cfg.embed_dim), F32)
        b_specs["candidates"] = P(rules["candidates"], None)
        # batch=1: replicate the (tiny) per-request inputs
        b_specs["sparse_ids"] = P(None, None, None)
        if "dense" in b_specs:
            b_specs["dense"] = P(None, None)
        return CellBuild(arch, cell.name, "serve", step, model,
                         (p_struct, batch), (p_specs, b_specs), None, rules)

    step = S.make_recsys_serve_step(cfg, device=META)
    batch, b_specs = mk_batch(B, False)
    return CellBuild(arch, cell.name, "serve", step, model,
                     (p_struct, batch), (p_specs, b_specs), None, rules)


# ---------------------------------------------------------------------------
# ColBERT cells (the paper's own workload — extra beyond the assigned 40)
# ---------------------------------------------------------------------------
def _colbert_cell(cfg: ColbertConfig, cell: ShapeCell, mesh,
                  arch: str) -> CellBuild:
    from repro_torch.models.colbert import init_colbert
    dp = mesh_batch_axes(mesh)
    fsdp = mesh_fsdp_axes(mesh) if cfg.trunk.fsdp_params else None
    model = init_colbert(cfg, device=META)
    # BERT vocab (30522) does not divide tp=16 -> replicate embeddings
    # (the trunk is ~110M params; embed is 23MB — replication is free)
    p_rules = ([(r"embed/table$", (None, None)),
                (r"lm_head/w$", (None, None)), (r"lm_head/b$", (None,))]
               + lm_param_rules(fsdp))
    p_struct, p_specs = _params(model, p_rules)
    rules = rules_api.retrieval_rules(dp)

    if cell.name == "index_build":
        step = S.make_colbert_index_step(cfg, device=META)
        batch = {"doc_tokens": sds((cell.dim("n_docs"),
                                    cell.dim("doc_len")), I32)}
        b_specs = {"doc_tokens": P(dp, None)}
        return CellBuild(arch, cell.name, "index", step, model,
                         (p_struct, batch), (p_specs, b_specs), None, rules)

    step = S.make_colbert_search_step(cfg, device=META)
    batch = {
        "q_tokens": sds((cell.dim("n_queries"), cell.dim("query_len")), I32),
        "doc_vecs": sds((cell.dim("n_docs"), cell.dim("doc_len"),
                         cfg.proj_dim), F32),
        "doc_mask": sds((cell.dim("n_docs"), cell.dim("doc_len")), BOOL),
    }
    b_specs = {"q_tokens": P(rules.get("queries"), None),
               "doc_vecs": P(dp, None, None),
               "doc_mask": P(dp, None)}
    return CellBuild(arch, cell.name, "search", step, model,
                     (p_struct, batch), (p_specs, b_specs), None, rules)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------
def build_cell(arch: str, cell_name: str, mesh,
               unroll: bool = False,
               layers_override: Optional[int] = None,
               cfg_overrides: Optional[dict] = None,
               rules_overrides: Optional[dict] = None) -> CellBuild:
    cfg = get_config(arch)
    if cfg_overrides:
        trunk_over = {k[6:]: v for k, v in cfg_overrides.items()
                      if k.startswith("trunk.")}
        own = {k: v for k, v in cfg_overrides.items()
               if not k.startswith("trunk.")}
        if trunk_over and isinstance(cfg, ColbertConfig):
            cfg = dataclasses.replace(
                cfg, trunk=dataclasses.replace(cfg.trunk, **trunk_over))
        if own:
            cfg = dataclasses.replace(cfg, **own)
    if unroll and isinstance(cfg, TransformerConfig):
        cfg = dataclasses.replace(cfg, unroll_scans=True)
    if unroll and isinstance(cfg, ColbertConfig):
        cfg = dataclasses.replace(
            cfg, trunk=dataclasses.replace(cfg.trunk, unroll_scans=True))
    if layers_override is not None:
        if isinstance(cfg, TransformerConfig):
            cfg = dataclasses.replace(cfg, n_layers=layers_override)
        elif isinstance(cfg, DimeNetConfig):
            cfg = dataclasses.replace(cfg, n_blocks=layers_override)
        elif isinstance(cfg, ColbertConfig):
            cfg = dataclasses.replace(cfg, trunk=dataclasses.replace(
                cfg.trunk, n_layers=layers_override))
    cells = {c.name: c for c in shapes_for(cfg)}
    cell = cells[cell_name]
    if isinstance(cfg, TransformerConfig):
        built = _lm_cell(cfg, cell, mesh, arch)
    elif isinstance(cfg, DimeNetConfig):
        built = _gnn_cell(cfg, cell, mesh, arch)
    elif isinstance(cfg, RecsysConfig):
        built = _recsys_cell(cfg, cell, mesh, arch)
    elif isinstance(cfg, ColbertConfig):
        built = _colbert_cell(cfg, cell, mesh, arch)
    else:
        raise TypeError(type(cfg))
    if rules_overrides:
        built.rules = {**built.rules, **rules_overrides}
    return built


def all_cells(arch: str):
    return [c.name for c in shapes_for(get_config(arch))]


def input_specs(arch: str, cell_name: str, mesh) -> Tuple[Any, ...]:
    """The cell's model inputs as shape-only stand-ins (``meta`` tensors,
    the reference's ``ShapeDtypeStruct``s)."""
    return build_cell(arch, cell_name, mesh).args
