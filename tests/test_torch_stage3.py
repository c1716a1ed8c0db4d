"""The dry run's stage 3 over the production mesh, at one layer, where
it stopped before the models carried the reference's annotations; the
row-sharded embedding gather; a missing collective term.

* One cell of each place it stopped (the residual add in
  train / prefill and in decode, the head views of 12 heads and 8 kv
  heads over 16 ranks and of 40 heads under ``attn_shard="sequence"``,
  DimeNet's products, the recsys gather of the card machine's torch):
  stage 3 runs to its end over the fake (16, 16) group, the cell is
  ``ok`` and its per-rank figures and collectives are stage 3's.
* dlrm-rm2 ``serve_p99``: no collective returns a table; the only one
  is the bags' all-reduce over ``model`` (each rank's [512 / 16, 26, 1,
  64] rows and [.., 1] wide rows, bf16), byte for byte. On
  ``train_batch`` the largest collective is at most a rank's parameter
  bytes.
* The two embedding routes give the same bags, bit for bit: the masked
  per-shard gather summed over any split of the rows (``local_rows``)
  and, on a one-rank mesh, the DTensor route, against the single call,
  in f32 and bf16, bags of 1 and 3 ids.
* A roofline of a stopped stage 3 shows the collective term missing
  (None), not 0, in the terms and in the report.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun

SITES = {
    "transformer.py:91 (train / prefill residual)": ("qwen1.5-0.5b",
                                                      "train_4k"),
    "transformer.py:99 (decode residual)": ("qwen1.5-0.5b", "decode_32k"),
    "attention.py:97 (8 kv heads over 16)": ("qwen2.5-14b", "long_500k"),
    "attention.py:97 (12 heads over 16)": ("colbertv2", "search"),
    "attention.py:98 (decode kv view)": ("qwen3-0.6b", "decode_32k"),
    "attention.py:217 (40 heads, sequence)": ("qwen2.5-14b",
                                              "prefill_32k"),
    "layers.py:67 (DimeNet)": ("dimenet", "molecule"),
    "embedding.py:48 (recsys, torch 2.11)": ("dlrm-rm2", "serve_p99"),
}


@pytest.mark.parametrize("site", SITES)
def test_stage3_runs_to_its_end(site):
    arch, cell = SITES[site]
    r = dryrun.run_cell(arch, cell, layers_override=1, verbose=False)
    assert r["ok"] and r["stage3_stopped"] is None, r["stage3_stopped"]
    assert r["per_rank_from"] == "stage 3"
    assert r["collectives"] is not None and r["collective_bytes"] > 0
    assert r["flops"] == r["per_rank"]["flops"]
    assert r["temp_size_in_bytes"] == r["per_rank"]["activation_peak_bytes"]


def test_serve_collectives_return_no_table():
    from repro_torch.configs import get_config
    cfg = get_config("dlrm-rm2")
    r = dryrun.run_cell("dlrm-rm2", "serve_p99", verbose=False)
    rows = 512 // 16 * cfg.n_sparse * cfg.multi_hot * 2      # bf16
    assert r["collectives"] == {"all-reduce": {
        "count": 2, "bytes": rows * cfg.embed_dim + rows}}
    table = r["arg_bytes"]["params"]                # a rank's tables
    assert r["collective_bytes"] < table / 1000


def test_train_collectives_no_larger_than_a_rank_params():
    """dlrm-rm2 train_batch: the largest collective is the tables'
    gradient reduced over ``data`` on a rank's own row shard, no more
    than the rank's parameter bytes (a table gathered whole would be
    16 times that)."""
    r = dryrun.run_cell("dlrm-rm2", "train_batch", verbose=False)
    assert r["ok"] and set(r["collectives"]) == {"all-reduce"}
    assert 0 < r["largest_collective_bytes"] <= r["arg_bytes"]["params"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("multi_hot", [1, 3])
def test_embedding_routes_bitwise(dtype, multi_hot):
    from repro_torch.models.recsys.embedding import embedding_bag, local_rows
    rng = np.random.default_rng(multi_hot)
    F, V, D, B = 5, 37, 8, 9
    tables = torch.as_tensor(rng.normal(size=(F, V, D)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, V, (B, F, multi_hot)))
    want = embedding_bag(tables, ids, dtype=dtype)
    for n in (2, 3, 4, 16):
        shards = torch.chunk(tables, n, dim=1)
        offs = np.cumsum([0] + [s.shape[1] for s in shards])
        rows = local_rows(shards[0], 0, ids, dtype)
        for s, o in zip(shards[1:], offs[1:]):
            rows = rows + local_rows(s, int(o), ids, dtype)
        assert torch.equal(rows.sum(dim=2), want)
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.sharding.api import mesh_context, recsys_rules
    from torch.distributed.tensor import DTensor
    with process_group("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with mesh_context(mesh, recsys_rules("data")):
            got = embedding_bag(tables, ids, dtype=dtype)
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), want)


def test_missing_collective_term_is_none():
    from repro_torch.roofline import analysis, report
    t = analysis.RooflineTerms(arch="a", cell="c", mesh="16x16", flops=1e12,
                               hlo_bytes=1e9, collective_bytes=None)
    assert t.collective_s is None
    assert t.bottleneck == "compute"
    assert t.step_time_s == t.compute_s
    assert "missing" in t.row()
    r = {"arch": "a", "cell": "c", "mesh": "16x16", "collective_bytes": None,
         "flops": 1e12, "bytes_accessed": 1e9}
    assert analysis.from_dryrun(r).collective_bytes is None
    terms = {"compute_s": t.compute_s, "memory_s": t.memory_s,
             "collective_s": None, "bottleneck": t.bottleneck,
             "useful_flops_frac": 0.0, "mfu": 0.0}
    table = report.roofline_table([{"arch": "a", "cell": "c",
                                    "terms": terms}])
    assert "missing (stage 3 stopped)" in table
    assert "stage 3 stopped" in report.collective_summary(
        [{"arch": "a", "cell": "c", "collectives": None}])
