"""The port's dry run (``repro_torch.launch.dryrun``) and the ``meta``
repairs it needs, held to the JAX package.

* The cells of Kimi K2, Moonshot and Qwen2.5-14B (12) run stages 1-2
  at one layer over the (16, 16) mesh of the fake group
  (``test_torch_roofline.py`` runs the other 30 with ``check_cell``, so
  xdist's ``--dist loadfile`` spreads the traces): each
  rank's argument bytes equal the bytes of the reference's
  ``build_cell`` leaves split by its specs over the production axis
  sizes, to the byte (arithmetic: nothing is lowered); the step runs to
  its end at the global shapes with every tensor on ``meta``, and the
  process allocates no real memory for it.
* The repairs hold on real tensors: ``_load_means`` is ``bincount``'s
  counts bitwise; ``sorted_segment_sum`` on the CPU is the padded-CSR
  sum bitwise; a decode step with a host ``pos`` (what the dry run
  passes) equals one with a 0-d tensor bitwise; the kernel wrappers
  trace their plain versions on ``meta``; the ColBERT search step
  honours ``maxsim_impl`` there and is unchanged on the CPU.
* An uneven split (a (3, 5) mesh) keeps rank 0's padding and lists it.
* ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --cell
  decode_32k`` in a subprocess: ``1 ok, 0 failed``, its stage 3 run to
  its end with the collectives counted.
* A stage 3 that stops (the head views without their layout, put back:
  a plain ``view`` of 8 kv heads over 16 ranks) fails the cell and
  keeps the op, file and line.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import all_cells
from torch_cells import check_cell, reference_rank_bytes

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
HERE = ("kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "qwen2.5-14b")
CELLS = [(a, c) for a in HERE for c in all_cells(a)]


@pytest.mark.parametrize("arch,cell", CELLS)
def test_cell_stages_1_2(arch, cell):
    r = check_cell(arch, cell, layers=1)
    if r["kind"] == "decode":
        assert "pos = seq_len - 1" in r["note"]
    if r["kind"] == "train":
        assert r["arg_bytes"]["opt_state"] > 0


def test_dryrun_subprocess_one_cell():
    """The CLI at full depth (28 layers) on one decode cell."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--cell", "decode_32k"], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert ("=== dry-run: 1 ok, 0 failed, collectives counted for 1 ==="
            in out.stdout)
    assert "collective_bytes=" in out.stdout
    assert "stage 3 stopped" not in out.stdout


def test_uneven_split_keeps_its_padding():
    """Over a (3, 5) mesh Qwen3-0.6B's widths do not divide: rank 0
    holds the larger chunks, padding included, as the reference's specs
    give them, and each uneven leaf is listed with its padding."""
    r = dryrun.run_cell("qwen3-0.6b", "decode_32k", layers_override=1,
                        mesh_shape=(3, 5), stages=1, verbose=False)
    assert r["arg_bytes"] == reference_rank_bytes(
        "qwen3-0.6b", "decode_32k", 1, {"data": 3, "model": 5})
    assert r["uneven"] and all(u["pad_bytes"] > 0 for u in r["uneven"])
    assert r["padding_bytes"] == sum(u["pad_bytes"] for u in r["uneven"])
    assert r["global"] is None and r["flops"] is None


def test_stage3_stop_is_reported_with_op_and_line(monkeypatch):
    from repro_torch.models import attention

    def plain_view(x, n, *names):         # a head view with no layout
        return x.view(*x.shape[:-1], n, x.shape[-1] // n)

    monkeypatch.setattr(attention, "split_last", plain_view)
    r = dryrun.run_cell("qwen3-0.6b", "decode_32k", layers_override=1,
                        verbose=False)
    assert r["ok"] is False
    assert r["collectives"] is None and r["collective_bytes"] is None
    stop = r["stage3_stopped"]
    assert stop["op"].startswith("aten.")
    path, line = stop["where"].rsplit(":", 1)
    assert path.startswith("repro_torch/models/") and int(line) > 0
    assert r["per_rank_from"] == "even split"
    assert r["flops"] == r["global"]["flops"] / 256


# ---------------------------------------------------------------------------
# The meta repairs, on real tensors
# ---------------------------------------------------------------------------
def test_load_means_counts_bitwise_bincount():
    from repro_torch.models.moe import _load_means
    rng = np.random.default_rng(0)
    for E, T, k in ((8, 37, 2), (64, 512, 6), (384, 100, 8)):
        ids = torch.as_tensor(rng.integers(0, E, (T, k)))
        probs = torch.softmax(torch.as_tensor(
            rng.normal(size=(T, E)).astype(np.float32)), dim=-1)
        me, ce = _load_means(probs, ids, E)
        want = torch.bincount(ids.reshape(-1), minlength=E).float() / T
        assert torch.equal(ce, want)
        assert torch.equal(me, probs.mean(dim=0))
        meta = _load_means(probs.to("meta"), ids.to("meta"), E)
        assert [tuple(t.shape) for t in meta] == [(E,), (E,)]


def _csr_sum(x, seg, n):
    """The padded-CSR sum as ``sorted_segment_sum`` had it before the
    ``meta`` branch."""
    M = x.shape[0]
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=n)
    width = int(counts.max()) if M else 0
    first = torch.cumsum(counts, 0) - counts
    sorted_seg = seg[order]
    col = torch.arange(M) - first[sorted_seg]
    table = torch.full((n, max(width, 1)), M, dtype=torch.long)
    table[sorted_seg, col] = order
    rows = torch.cat([x, x.new_zeros(1, x.shape[1])])
    return torch.nn.functional.embedding(table, rows, padding_idx=M).sum(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_segment_sum_cpu_unchanged(dtype):
    from repro_torch.core.segment import sorted_segment_sum
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(500, 24)).astype(np.float32)
                        ).to(dtype)
    seg = torch.as_tensor(rng.integers(0, 37, 500))
    got = sorted_segment_sum(x, seg, 40)
    assert torch.equal(got, _csr_sum(x, seg, 40))
    meta = sorted_segment_sum(x.to("meta"), seg.to("meta"), 40)
    assert meta.shape == (40, 24) and meta.dtype == dtype
    want = torch.zeros(40, 24).index_add_(0, seg, x.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2e-2, atol=5e-2)


def test_decode_with_host_pos_is_bitwise():
    """The dry run passes ``pos`` as a host int; the step gives the same
    bits as with a 0-d tensor, at every position of a prefilled cache."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import (make_lm_decode_step,
                                          make_lm_prefill_step)
    from repro_torch.models.transformer import init_transformer
    cfg = get_smoke_config("qwen3-0.6b")
    model = init_transformer(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)), dtype=torch.int32)
    _, cache = make_lm_prefill_step(cfg, max_len=12, device="cpu")(
        model, {"tokens": tokens})
    decode = make_lm_decode_step(cfg, device="cpu")
    tok = tokens[:, -1:]
    for pos in (8, 11):
        a_cache = {k: v.clone() for k, v in cache.items()}
        b_cache = {k: v.clone() for k, v in cache.items()}
        a, a_cache = decode(model, a_cache, {"token": tok, "pos": pos})
        b, b_cache = decode(model, b_cache, {"token": tok,
                                             "pos": torch.tensor(pos)})
        assert torch.equal(a, b)
        assert all(torch.equal(a_cache[k], b_cache[k]) for k in a_cache)


def test_wrappers_trace_plain_versions_on_meta():
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    from repro_torch.kernels.maxsim.ops import maxsim, maxsim_rerank
    m = torch.device("meta")
    reset_launch_counts()
    q = torch.empty(3, 5, 16, device=m)
    qm = torch.ones(3, 5, dtype=torch.bool, device=m)
    d = torch.empty(7, 6, 16, device=m)
    dm = torch.ones(7, 6, dtype=torch.bool, device=m)
    assert maxsim(q, qm, d, dm).shape == (3, 7)
    assert maxsim_rerank(q, qm, torch.empty(3, 4, 6, 16, device=m),
                         torch.ones(3, 4, 6, dtype=torch.bool,
                                    device=m)).shape == (3, 4)
    o = flash_attention(torch.empty(1, 4, 32, 64, device=m),
                        torch.empty(1, 2, 32, 64, device=m),
                        torch.empty(1, 2, 32, 64, device=m), causal=True)
    assert o.shape == (1, 4, 32, 64) and o.is_meta
    a, best = kmeans_assign(torch.empty(2, 9, 16, device=m),
                            torch.empty(2, 4, 16, device=m))
    assert a.shape == best.shape == (2, 9) and a.is_meta
    assert not any(launch_counts().values())


def test_search_step_honours_maxsim_impl_on_meta():
    """On ``meta`` "einsum" materialises the [Nq, Nd, Lq, Ld] scores and
    "blocked" streams ``maxsim_block`` docs a pass: the same products, a
    smaller peak; on the CPU both run the plain version as before."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_colbert_search_step
    from repro_torch.models.colbert import init_colbert
    from repro_torch.roofline.analysis import TraceCounter
    cfg = get_smoke_config("colbertv2")
    rng = np.random.default_rng(3)
    batch = {"q_tokens": torch.as_tensor(rng.integers(
        1, 100, (4, 8)), dtype=torch.int32),
        "doc_vecs": torch.as_tensor(rng.normal(size=(64, 12, cfg.proj_dim)
                                               ).astype(np.float32)),
        "doc_mask": torch.as_tensor(rng.random((64, 12)) < 0.8)}
    model = init_colbert(cfg, seed=0, device="cpu")
    meta_model = init_colbert(cfg, device="meta")
    meta_batch = {k: v.to("meta") for k, v in batch.items()}
    peaks, flops, cpu = {}, {}, {}
    for impl in ("einsum", "blocked"):
        c = dataclasses.replace(cfg, maxsim_impl=impl, maxsim_block=16)
        with torch.no_grad():
            cpu[impl] = make_colbert_search_step(c, k=5, device="cpu")(
                model, batch)
            counter = TraceCounter([meta_model.parameters(), meta_batch])
            with counter:
                s, i = make_colbert_search_step(c, k=5, device="meta")(
                    meta_model, meta_batch)
        assert s.is_meta and s.shape == (4, 5) and i.shape == (4, 5)
        peaks[impl], flops[impl] = counter.peak_bytes, counter.flops
    assert flops["einsum"] == flops["blocked"]
    assert peaks["einsum"] > peaks["blocked"]
    for a, b in zip(cpu["einsum"], cpu["blocked"]):
        assert torch.equal(a, b)
