"""The port's roofline (``repro_torch.roofline``) against the JAX
package's, and the rest of the dry run's cells.

* The 30 cells ``test_torch_dryrun.py`` leaves (Qwen3-0.6B,
  Qwen1.5-0.5B, DimeNet, the four recsys models, ColBERT) pass stages
  1-2 at one layer with ``check_cell`` (per-rank argument bytes equal
  the reference's to the byte, nothing real allocated); the 16 recsys
  cells run stage 3 to its end with their collectives counted.
* On a hand-counted sharded matmul over a fake (16, 16) group, the
  all-gather bytes and one rank's FLOPs equal the hand count.
* ``_model_flops``, ``model_flops_lm`` and ``model_flops_decode`` equal
  the reference's on all 40 cells to 1e-12 relative; every term of the
  packed-rerank and PLAID-probe models equals the reference's at its
  ``DEFAULT_SHAPE`` and at the main path's shapes, bits 2 and 4; the
  hillclimb variants are the reference's.
* ``RooflineTerms`` on hand values with the H100's constants.
* The 2-and-4-layer extrapolation equals a full trace of six layers.
"""
import os

import pytest
import torch

from repro.roofline import analysis as j_analysis
from repro.roofline import packed as j_packed
from repro.roofline import probe as j_probe
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import all_cells
from repro_torch.roofline import analysis, hw, packed, probe
from repro_torch.roofline.run import _model_flops, extrapolate
from torch_cells import check_cell

_saved = os.environ.get("XLA_FLAGS")
# the reference's runner and hillclimb add a 512-device XLA flag when
# imported; it must not reach this worker's later JAX tests
from repro.roofline import hillclimb as j_hillclimb  # noqa: E402
from repro.roofline import run as j_run  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

RECSYS = ("wide-deep", "deepfm", "fm", "dlrm-rm2")
HERE = ("qwen3-0.6b", "qwen1.5-0.5b", "dimenet") + RECSYS + ("colbertv2",)
CELLS = [(a, c) for a in HERE for c in all_cells(a)]
# the main path's shapes (``chip_smoke.py``: 32 queries of 32 tokens, a
# 1,024-candidate slate of Ward f = 2 docs of 129 slots, K = 256; the
# probe over 16,384 candidate slots, each centroid's doc list at most
# the corpus)
MAIN_PACKED = dict(nq=32, lq=32, s=1024, ld=129, dim=128, k_centroids=256)
MAIN_PROBE = dict(nq=32, lq=32, k_centroids=256, nprobe=8, lmax=16384,
                  c=16384, ld=129, dim=128)


@pytest.mark.parametrize("arch,cell", CELLS)
def test_cell_stages(arch, cell):
    recsys = arch in RECSYS
    r = check_cell(arch, cell, layers=1, stages=3 if recsys else 2)
    if recsys:
        assert r["stage3_stopped"] is None, r["stage3_stopped"]
        assert r["collectives"] is not None and r["collective_bytes"] > 0
        assert r["per_rank_from"] == "stage 3"
        assert r["flops"] == r["per_rank"]["flops"]


def test_sharded_matmul_hand_count():
    """A [64, 1024] rows over data times B [1024, 4096] columns over
    model: no collective, each rank 2 x 4 x 1024 x 256 FLOPs; gathering
    the product's rows over data is one all-gather of a [64, 256] f32
    result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    with fake_process_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        A = DTensor.from_local(torch.empty(4, 1024, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(64, 1024), stride=(1024, 1))
        B = DTensor.from_local(torch.empty(1024, 256, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(1024, 4096), stride=(4096, 1))
        counter = analysis.TraceCounter([A, B])
        with counter:
            C = A @ B
        assert counter.flops == 2 * 4 * 1024 * 256
        assert counter.by_op == {}
        assert C.to_local().shape == (4, 256)
        counter = analysis.TraceCounter([A, B, C])
        with counter:
            D = C.redistribute(mesh, [Replicate(), Shard(1)])
        coll = analysis.collective_bytes_from_trace(counter)
        assert coll == {"total": 64 * 256 * 4, "by_op": {
            "all-gather": {"count": 1, "bytes": 64 * 256 * 4}}}
        assert D.to_local().shape == (64, 256) and counter.flops == 0


def test_trace_counter_lifetimes():
    """The peak counts what is live at once, not what was made."""
    x = torch.empty(1000, device="meta")
    counter = analysis.TraceCounter([x])
    with counter:
        for _ in range(3):
            y = x * 2
            z = y + 1
            del y
        w = z.view(10, 100)
    assert counter.peak_bytes == 3 * 4000       # a z, a y and the next z
    assert counter.live_bytes == 4000 and w.shape == (10, 100)


def test_roofline_terms_on_h100():
    t = analysis.RooflineTerms(
        arch="a", cell="c", mesh="16x16", flops=hw.PEAK_FLOPS_BF16,
        hlo_bytes=hw.HBM_BW * 2, collective_bytes=hw.LINK_BW * 0.5,
        model_flops=hw.PEAK_FLOPS_BF16 / 2)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(0.5)
    assert t.bottleneck == "memory" and t.step_time_s == pytest.approx(2.0)
    assert t.useful_flops_frac == pytest.approx(0.5)
    assert t.mfu == pytest.approx(0.25)
    assert (hw.HBM_BW, hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32,
            hw.PEAK_FLOPS_F32, hw.MMA_SYNC_TF32_FLOPS, hw.LINK_BW) == (
        3.35e12, 989e12, 494.7e12, 67e12, 310.5e12, 450e9)
    assert 80e9 <= hw.HBM_BYTES <= 2 ** 37


def _rel_equal(a, b):
    assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (a, b)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_equal_reference(arch):
    from repro.configs import get_config as j_get_config
    from repro_torch.configs.base import LM_SHAPES, TransformerConfig
    cells = all_cells(arch)
    for cell in cells:
        for n in (256, 512):
            _rel_equal(_model_flops(arch, cell, n),
                       j_run._model_flops(arch, cell, n))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if isinstance(cfg, TransformerConfig):
        for c in LM_SHAPES:
            seq, gb = c.dim("seq_len"), c.dim("global_batch")
            kind = "train" if c.kind == "train" else "prefill"
            _rel_equal(analysis.model_flops_lm(cfg, kind, seq * gb, 256,
                                               seq_len=seq),
                       j_analysis.model_flops_lm(jcfg, kind, seq * gb, 256,
                                                 seq_len=seq))
            _rel_equal(analysis.model_flops_decode(cfg, gb, seq, 256),
                       j_analysis.model_flops_decode(jcfg, gb, seq, 256))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("where", ["default", "main"])
def test_packed_and_probe_terms_equal_reference(bits, where):
    sh = dict(packed.DEFAULT_SHAPE if where == "default" else MAIN_PACKED)
    assert packed.DEFAULT_SHAPE == j_packed.DEFAULT_SHAPE
    nq, lq, s, ld, dim, kc = (sh[k] for k in ("nq", "lq", "s", "ld", "dim",
                                              "k_centroids"))
    for fn, args in (("packed_flops", (nq, lq, s, ld, dim, kc, bits)),
                     ("packed_stream_bytes", (nq, lq, s, ld, dim, kc, bits)),
                     ("recon_flops", (nq, lq, s, ld, dim)),
                     ("recon_stream_bytes", (nq, lq, s, ld, dim)),
                     ("packed_doc_bytes_per_token", (dim, bits)),
                     ("words_per_token", (dim, bits))):
        assert getattr(packed, fn)(*args) == getattr(j_packed, fn)(*args), fn
    p = dict(probe.DEFAULT_SHAPE if where == "default" else MAIN_PROBE)
    assert probe.DEFAULT_SHAPE == j_probe.DEFAULT_SHAPE
    nq, lq, kc, npb, lmax, c, ld, dim = (p[k] for k in (
        "nq", "lq", "k_centroids", "nprobe", "lmax", "c", "ld", "dim"))
    for fn, args in (("probe_flops", (nq, lq, kc, dim)),
                     ("gather_bytes", (nq, lq, npb, lmax)),
                     ("dedupe_flops", (nq, lq, npb, lmax)),
                     ("onehot_decode_flops", (nq, c, ld, kc, lq)),
                     ("reduce_flops", (nq, c, ld, lq)),
                     ("device_stream_bytes", (nq, lq, kc, npb, lmax, c, ld,
                                              dim)),
                     ("host_hop_bytes", (nq, lq, npb, c))):
        assert getattr(probe, fn)(*args) == getattr(j_probe, fn)(*args), fn
    # the reports' rows: the same counts, priced on the H100
    got = packed.packed_rerank_report(sh, bits_list=(bits,),
                                      cross_check=False)["rows"]
    want = j_packed.packed_rerank_report(sh, bits_list=(bits,),
                                         cross_check=False)["rows"]
    for g, w in zip(got, want):
        for k in ("flops", "stream_bytes", "flop_terms",
                  "doc_bytes_per_token", "bytes_ratio_vs_recon"):
            assert g[k] == w[k], k
        assert g["terms"].memory_s == g["stream_bytes"] / hw.HBM_BW
    for g, w in zip(probe.plaid_probe_report(p)["rows"],
                    j_probe.plaid_probe_report(p)["rows"]):
        for k in ("flops", "stream_bytes", "flop_terms", "host_hop_bytes"):
            assert g[k] == w[k], k


def test_packed_plain_flops_cross_check():
    """The plain version's products at the cross-check's shape: the
    scoring einsum (2 Nq Lq S Ld dim) and nothing else, since the plain
    version decodes by gathers."""
    f = packed._plain_ref_flops(2, 4, 8, 6, 128, 2)
    assert f == 2 * 2 * 4 * 8 * 6 * 128


def test_extrapolation_equals_a_full_trace():
    """Traces at 2 and 4 layers carried to 6 equal a 6-layer trace
    exactly: a decode cell of Qwen3-0.6B and DimeNet's molecule cell
    (six blocks, its own depth)."""
    for arch, cell in (("qwen3-0.6b", "decode_32k"),
                       ("dimenet", "molecule")):
        runs = [dryrun.run_cell(arch, cell, unroll=True, layers_override=n,
                                verbose=False, stages=2) for n in (2, 4, 6)]
        for key in ("flops", "bytes_accessed"):
            assert extrapolate(runs[0], runs[1], 6, key) == runs[2][key], \
                (arch, key)
        assert runs[0]["flops"] < runs[2]["flops"]


def test_hillclimb_variants_are_the_reference():
    from repro_torch.roofline.hillclimb import VARIANTS
    assert VARIANTS == j_hillclimb.VARIANTS


def test_maxsim_blocked_variant_changes_the_trace():
    base = dryrun.run_cell("colbertv2", "search", layers_override=1,
                           verbose=False, stages=2)
    blocked = dryrun.run_cell("colbertv2", "search", layers_override=1,
                              verbose=False, stages=2,
                              cfg_overrides={"maxsim_impl": "blocked"})
    assert blocked["global"]["flops"] == base["global"]["flops"]
    assert (blocked["global"]["activation_peak_bytes"]
            < base["global"]["activation_peak_bytes"])


def test_report_holds_to_80_gb():
    from repro_torch.roofline import report
    row = {"arch": "a", "cell": "c", "mesh": "16x16",
           "argument_size_in_bytes": hw.HBM_BYTES - 10,
           "temp_size_in_bytes": 20, "output_size_in_bytes": 0}
    table = report.dryrun_table([row])
    assert "fits 80 GB" in table and "**NO**" in table
    row["temp_size_in_bytes"] = 10
    assert "| yes |" in report.dryrun_table([row])
