"""The cases of ``tests/test_torch_shard_ranks.py``, and one gloo rank of
its run: ``python tests/torch_shard_ranks.py OUT_DIR RANK WORLD STORE D M``.

Each case builds a small model of the port from a seed (f32), runs it
and returns its outputs as numpy arrays: with ``mesh`` None on one
process, plain tensors; with a ``("data", "model")`` mesh as a rank of
it, the parameters laid out by the reference's parameter rules
(``distribute_params``), the batch by the cells' specs, the step run as
the dry run's stage 3 runs it (``rank_context``: the reference's rule
set over the mesh), and every output's ``full_tensor()``.

* ``heads6``, ``kv2``, ``seq10``: Qwen3's SMOKE trunk at one layer with
  6 heads (6
  over 4 ranks: colbertv2's 12 over 16), with 4 heads over 2 kv heads
  (2 kv heads over 4 ranks in decode: Kimi's and Qwen's 8 over 16), and
  with 10 heads under ``attn_shard="sequence"`` (Qwen2.5-14B's 40 over
  16; the chunked path at S = 16, chunk 4); prefill (``lm_rules``),
  two decode steps (``lm_decode_rules``) and a train step's loss and
  gradients (``lm_grads``);
* ``colbert``: the ColBERT SMOKE encoder at one layer with 6 heads,
  ``retrieval_rules``: padded docs' vectors and emit mask;
* ``dimenet``: a DimeNet SMOKE train step on 4 molecules
  (``gnn_rules``): loss and gradients;
* ``dlrm``: dlrm-rm2 SMOKE serve logits, its embedding bags, and a train
  step's loss and gradients (``recsys_rules``: the tables' rows over
  ``model``).

It imports the port only (no JAX). A rank writes OUT_DIR/rank<RANK>.npz.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

CPU = torch.device("cpu")
F32 = dict(dtype="float32", param_dtype="float32")
LM_CASES = {
    "heads6": dict(n_heads=6, n_kv_heads=6),
    "kv2": dict(n_heads=4, n_kv_heads=2),
    "seq10": dict(n_heads=10, n_kv_heads=2, attn_shard="sequence",
                  attn_full_threshold=8, attn_chunk=4),
}
CASES = (*LM_CASES, "colbert", "dimenet", "dlrm")
B, S, MAX_LEN = 4, 16, 20


def lm_config(case):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen3-0.6b"), n_layers=1,
                               **F32, **LM_CASES[case])


def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def _laid(t, mesh, *spec):
    """``t`` (the same on every rank) laid out as ``spec`` over ``mesh``;
    ``t`` itself with no mesh."""
    if mesh is None:
        return t
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.api import P, placements
    return distribute_tensor(t, mesh, placements(P(*spec), mesh))


def _context(mesh, rules):
    import contextlib
    from repro_torch.launch.dryrun import rank_context
    return contextlib.nullcontext() if mesh is None else rank_context(
        mesh, rules)


def _grads(out, grads, prefix="grad/"):
    from repro_torch.train.params import tree_paths
    for path, g in tree_paths(grads):
        out[prefix + path] = _full(g)


def lm_case(case, mesh=None, model=None):
    """-> outputs of ``case`` (``model``: its weights, else seed 1)."""
    from repro_torch.launch.steps import (lm_grads, make_lm_decode_step,
                                          make_lm_prefill_step)
    from repro_torch.models.transformer import init_transformer
    from repro_torch.sharding.api import lm_decode_rules, lm_rules
    from repro_torch.sharding.params import distribute_params, lm_param_rules
    cfg = lm_config(case)
    model = model or init_transformer(cfg, seed=1, device=CPU)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32)
    new = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, B, 1)),
                          dtype=torch.int32)
    if mesh is not None:
        distribute_params(model, mesh, lm_param_rules("data"))
    out = {}
    with _context(mesh, lm_rules("data", attn_shard=cfg.attn_shard)):
        logits, cache = make_lm_prefill_step(cfg, max_len=MAX_LEN,
                                             device=CPU)(
            model, {"tokens": _laid(tokens, mesh, "data", None)})
        out["prefill"] = _full(logits)
        loss, grads = lm_grads(model, _laid(tokens, mesh, "data", None),
                               _laid(labels, mesh, "data", None), cfg)
        out["loss"] = _full(loss)
        _grads(out, grads)
    decode = make_lm_decode_step(cfg, device=CPU)
    with _context(mesh, lm_decode_rules("data")):
        for i in range(2):
            logits, cache = decode(model, cache, {
                "token": _laid(new[i], mesh, "data", None), "pos": S + i})
            out[f"decode{i}"] = _full(logits)
    out["cache_k"], out["cache_v"] = _full(cache["k"]), _full(cache["v"])
    return out


def colbert_case(mesh=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.colbert import encode_docs, init_colbert
    from repro_torch.sharding.api import retrieval_rules
    from repro_torch.sharding.params import distribute_params, lm_param_rules
    cfg = get_smoke_config("colbertv2")
    cfg = dataclasses.replace(cfg, trunk=dataclasses.replace(
        cfg.trunk, n_layers=1, n_heads=6, n_kv_heads=6, **F32))
    model = init_colbert(cfg, seed=3, device=CPU)
    if mesh is not None:
        distribute_params(model, mesh, [
            (r"embed/table$", (None, None))] + lm_param_rules("data"))
    d = torch.as_tensor(np.random.default_rng(4).integers(8, 200, (B, 20)),
                        dtype=torch.int32)
    d[:, 15:] = 0                                   # padding
    with _context(mesh, retrieval_rules("data")):
        dv, emit = encode_docs(model, _laid(d, mesh, "data", None))
    return {"d": _full(dv), "emit": _full(emit)}


def molecules(n_graphs=4, n_atoms=6, n_edges=10, cap=4, seed=5):
    """Molecule-cell inputs (numpy): random atom pairs, both ways."""
    from repro_torch.models.gnn.dimenet import build_triplets
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
    t_in, t_out, t_mask = build_triplets(ei, N, cap)
    inputs = {"pos": pos, "edge_index": ei, "t_in": t_in, "t_out": t_out,
              "t_mask": t_mask, "node_mask": np.ones(N, bool),
              "edge_mask": rng.random(E) < 0.9,
              "z": rng.integers(0, 10, N).astype(np.int32),
              "graph_ids": np.repeat(np.arange(n_graphs),
                                     n_atoms).astype(np.int32)}
    return inputs, rng.normal(size=(n_graphs, 1)).astype(np.float32)


def dimenet_case(mesh=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.gnn.dimenet import dimenet_loss, init_dimenet
    from repro_torch.sharding.api import gnn_rules
    from repro_torch.train.params import value_and_grad
    cfg = dataclasses.replace(get_smoke_config("dimenet"), **F32)
    model = init_dimenet(cfg, seed=6, device=CPU)
    inputs, targets = molecules(cap=cfg.triplet_cap)
    ep = ("data", "model")
    specs = {"pos": ("data", None), "edge_index": (None, ep),
             "t_in": (ep,), "t_out": (ep,), "t_mask": (ep,),
             "node_mask": ("data",), "edge_mask": (ep,), "z": ("data",),
             "graph_ids": ("data",)}
    if mesh is not None:
        from repro_torch.sharding.params import (distribute_params,
                                                 gnn_param_rules)
        distribute_params(model, mesh, gnn_param_rules(None))
    batch = {k: _laid(torch.as_tensor(v), mesh, *specs[k])
             for k, v in inputs.items()}
    batch["targets"] = _laid(torch.as_tensor(targets), mesh, None, None)
    with _context(mesh, gnn_rules("data")):
        loss, _, grads = value_and_grad(
            lambda m, b: (dimenet_loss(
                m, {k: v for k, v in b.items() if k != "targets"},
                b["targets"], cfg, task="graph", n_graphs=4), {}),
            model, batch)
    out = {"loss": _full(loss)}
    _grads(out, grads)
    return out


def dlrm_case(mesh=None, model=None):
    """-> serve logits, the train loss and gradients (``model``: its
    weights, else seed 7)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.recsys.embedding import embedding_bag
    from repro_torch.models.recsys.models import (init_recsys,
                                                  recsys_forward,
                                                  recsys_loss)
    from repro_torch.sharding.api import recsys_rules
    from repro_torch.train.params import value_and_grad
    cfg = dataclasses.replace(get_smoke_config("dlrm-rm2"), **F32)
    model = model or init_recsys(cfg, seed=7, device=CPU)
    if mesh is not None:
        from repro_torch.sharding.params import (distribute_params,
                                                 recsys_param_rules)
        distribute_params(model, mesh, recsys_param_rules(None))
    b = dlrm_batch(cfg)
    specs = {"sparse_ids": ("data", None, None), "dense": ("data", None),
             "label": ("data",)}
    batch = {k: _laid(torch.as_tensor(v), mesh, *specs[k])
             for k, v in b.items()}
    with _context(mesh, recsys_rules("data")):
        with torch.no_grad():
            logits = recsys_forward(model, batch, cfg)
            bags = embedding_bag(model.tables, batch["sparse_ids"])
        loss, _, grads = value_and_grad(
            lambda m, x: recsys_loss(m, x, cfg), model, batch)
    out = {"serve": _full(logits), "bags": _full(bags), "loss": _full(loss)}
    _grads(out, grads)
    return out


def dlrm_batch(cfg, n=8, seed=8):
    rng = np.random.default_rng(seed)
    return {"sparse_ids": np.stack(
        [rng.integers(0, v, (n, cfg.multi_hot)) for v in cfg.vocab_sizes],
        axis=1).astype(np.int32),
        "dense": rng.normal(size=(n, cfg.n_dense)).astype(np.float32),
        "label": (rng.random(n) < 0.3).astype(np.float32)}


def run_case(case, mesh=None):
    if case in LM_CASES:
        return lm_case(case, mesh)
    return {"colbert": colbert_case, "dimenet": dimenet_case,
            "dlrm": dlrm_case}[case](mesh)


def main(out_dir, rank, world, store_path, d, m):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, process_group
    out = {}
    store = dist.FileStore(store_path, world)
    with process_group("cpu", world_size=world, rank=rank, store=store):
        mesh = make_mesh((d, m), ("data", "model"), "cpu")
        for case in CASES:
            for k, v in run_case(case, mesh).items():
                out[f"{case}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         int(sys.argv[5]), int(sys.argv[6]))
