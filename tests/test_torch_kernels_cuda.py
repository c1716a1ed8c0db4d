"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips where no CUDA device exists (the
fixture decides at run time). Run on a card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.

Tolerances: Ward assignments equal (also at N = 512, on exact duplicate
tokens and on all-pad documents); probe -inf slots equal and finite
scores to 1e-5; packed rerank scores to 1e-5 (both also at Lq = 300, one
launch a chunk of 128 query tokens); the MaxSim kernels, the rerank
from gathered candidates and read from a store in place (invalid
candidates holding ids outside it), to rtol 1e-5, atol 1e-4 (3xTF32
tensor-core products or, above dim 132, f32 FMA, and sums in another
order); k-means assignment ids equal except where the top two
sims lie within 1e-5 (3xTF32 products in another order), best sims to
1e-5; dequantize
+ score to atol 1e-4, the reference test's tolerance (3xTF32 products;
ragged tiles, long queries, generic widths, the f32 body for rows too
wide for its tiles); flash attention
to 1e-5 in f32 (the online softmax rescales by the running max, the
plain version by the row max) and to 1e-2 (atol and rtol) in bf16, where
p and the output are rounded to bf16 at different scales on the two
sides (about one bf16 step at values near 2), rows that see no column
exactly 0 on both. The probe is also held at large centroid counts
(K = 512 to 16,384: the table in device memory) and on both routes where
both serve. The probe and packed-rerank
designs are also held on the shapes they were built for (a sparse path-like slate, duplicate
codes, an all-zero table, ragged tails, Ld = 129) to 1e-5; the packed
kernel past the limits it had before its token windows and dim slabs
(Ld to 20,000, dim 136 to 768, one launch a chunk of 128 query tokens,
counted); the all-pairs MaxSim
on the tile edges of its tensor-core design (one-token, short, long and
fully masked docs, sparse masks, a doc over two tiles, Lq = 40 and 300)
and the k-means assignment on its pass and row edges (K below 8, 136,
200 and 257; N not a multiple of 16; dims not a multiple of 8 or above
128; bf16).
"""
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bh)
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.kernels.maxsim.ops import (maxsim, maxsim_rerank,
                                            maxsim_rerank_indexed)
from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
from repro_torch.kernels.plaid_probe.ops import (KERNELS_A_LAUNCH,
                                                 plaid_probe_scores,
                                                 probe_route)
from repro_torch.kernels.quant.ops import dequant_score
from repro_torch.kernels.ward_pool.ops import ward_assign
from repro_torch.kernels.ward_pool.ref import ward_agree, ward_objective

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _unit(g, shape, dev):
    x = torch.randn(shape, generator=g, device=dev)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("N,d", [(20, 16), (256, 128), (300, 128),
                                 (512, 128)])
def test_ward_kernel_equals_plain(dev, N, d):
    g = torch.Generator(device=dev).manual_seed(N)
    x = torch.randn((6, N, d), generator=g, device=dev)
    n_valid = torch.randint(1, N + 1, (6,), generator=g, device=dev)
    n_valid[0] = 0
    mask = torch.arange(N, device=dev)[None] < n_valid[:, None]
    before = launch_counts()["ward_pool"]
    got = ward_assign(x, mask, 2)
    assert launch_counts()["ward_pool"] == before + 1
    assert torch.equal(got, ward_assign(x, mask, 2, impl="ref"))


@pytest.mark.parametrize("factor", [2, 3, 4, 6])
def test_ward_kernel_on_duplicate_tokens_ties_as_plain(dev, factor):
    """Each token repeated ``factor`` times and shuffled: exact
    zero-distance ties. The kernel's duplicates are exactly 0 apart, the
    plain version's (a torch sum and ``torch.bmm``) nearly so, so each
    breaks the ties along its own rounding: per document the assignments
    are equal or tie-equivalent (``ward_agree``: as many clusters, Ward
    objectives within 1e-5). N about 512 puts the triangle in device
    memory, about 256 in shared memory."""
    for n in (256 // factor, 512 // factor):
        g = torch.Generator(device=dev).manual_seed(factor * n)
        base = torch.randn((4, n, 128), generator=g, device=dev)
        x = base.repeat(1, factor, 1)[:, torch.randperm(
            n * factor, generator=g, device=dev)]
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
        mask[1, n * factor // 2:] = False
        got = ward_assign(x, mask, factor)
        want = ward_assign(x, mask, factor, impl="ref")
        assert ward_agree(x, mask, got, want, atol=1e-5).all()
        assert float(ward_objective(x, mask, got)[0]) < 1e-5


@pytest.mark.parametrize("N", [256, 512])
def test_ward_kernel_all_pad_document(dev, N):
    """A batch whose documents hold no valid token: no merge, each token
    its own representative, as the plain version."""
    x = torch.randn((3, N, 128), device=dev)
    mask = torch.zeros((3, N), dtype=torch.bool, device=dev)
    mask[1, :7] = True
    got = ward_assign(x, mask, 2)
    assert torch.equal(got, ward_assign(x, mask, 2, impl="ref"))
    assert torch.equal(got[0], torch.arange(N, device=dev,
                                            dtype=torch.int32))


@pytest.mark.parametrize("Lq", [32, 300])
def test_probe_kernel_equals_plain(dev, Lq):
    g = torch.Generator(device=dev).manual_seed(1)
    Nq, dim, K, C, L = 4, 128, 256, 700, 50
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.8
    codes = torch.randint(0, K, (Nq, C, L), generator=g, device=dev,
                          dtype=torch.int32)
    cm = torch.rand((Nq, C, L), generator=g, device=dev) < 0.7
    vm = torch.rand((Nq, C), generator=g, device=dev) < 0.8
    before = launch_counts()["plaid_probe"]
    got = plaid_probe_scores(q, qm, cen, codes, cm, vm, t_cs=0.1)
    # one launch (the table kernel, then the probe kernel) for each chunk
    # of at most 128 query tokens
    assert launch_counts()["plaid_probe"] == (
        before + KERNELS_A_LAUNCH * -(-Lq // 128))
    want = plaid_probe_scores(q, qm, cen, codes, cm, vm, t_cs=0.1, impl="ref")
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Lq", [32, 300])
@pytest.mark.parametrize("bits", [2, 4])
def test_packed_kernel_equals_plain(dev, bits, Lq):
    g = torch.Generator(device=dev).manual_seed(bits)
    Nq, dim, K, S, L = 4, 128, 256, 37, 50
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.8
    W = dim * bits // 32
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (Nq, S, L, W), generator=g,
                      device=dev, dtype=torch.int32)
    ids = torch.randint(0, K, (Nq, S, L), generator=g, device=dev,
                        dtype=torch.int32)
    dm = torch.rand((Nq, S, L), generator=g, device=dev) < 0.5
    dm[0, 0] = False                             # a fully masked candidate
    vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.1
    before = launch_counts()["maxsim_packed"]
    got = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits)
    assert launch_counts()["maxsim_packed"] == before + -(-Lq // 128)
    want = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits,
                                impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got[0, 0]) == 0.0


def _probe_hold(got, want):
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["sparse slate", "duplicate codes",
                                  "all-zero table", "ragged"])
def test_probe_kernel_design_cases(dev, case):
    """The table-once design on the shapes it was built for: a path-like
    slate (C = 4,096, 5% of slots valid, as a valid prefix), documents
    whose tokens repeat one or two codes (the kernel's distinct-code
    lookups; the other cases read every token), t_cs above every score
    (every table entry 0), and C not a multiple of the block's slots with
    L = 129 (codes rows at every 16-byte alignment)."""
    g = torch.Generator(device=dev).manual_seed(7)
    Nq, Lq, dim, K, L = 6, 32, 128, 256, 129
    C = 1000 if case == "ragged" else 4096
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.9
    codes = torch.randint(0, K, (Nq, C, L), generator=g, device=dev,
                          dtype=torch.int32)
    if case == "duplicate codes":
        codes = (codes[:, :, :1] + torch.randint(
            0, 2, (Nq, C, L), generator=g, device=dev,
            dtype=torch.int32)) % K
    cm = torch.rand((Nq, C, L), generator=g, device=dev) < 0.8
    vm = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    if case == "sparse slate":
        vm = torch.arange(C, device=dev)[None, :] < torch.randint(
            150, 260, (Nq, 1), generator=g, device=dev)
    t_cs = 2.0 if case == "all-zero table" else 0.1
    args = (q, qm, cen, codes.contiguous(), cm, vm)
    got = plaid_probe_scores(*args, t_cs=t_cs)
    _probe_hold(got, plaid_probe_scores(*args, t_cs=t_cs, impl="ref"))
    if case == "all-zero table":
        assert (got[vm] == 0).all()


@pytest.mark.parametrize("K,Lq,route,launches", [
    (2048, 32, "global", 1),              # past shared memory
    (512, 128, "global", 1),
    (512, 300, "global", 3),
    (16384, 32, "global", 1),             # ColBERT's rule at ~1.4e6 vectors
    (415, 300, "smem", 3),                # the last K that fits at 128
])
def test_probe_kernel_at_large_centroid_counts(dev, K, Lq, route, launches):
    """Every K is served: the table in shared memory where it fits, else
    read from device memory; the distinct-code path (crowded codes) and
    the full read both held."""
    from repro_torch.kernels.plaid_probe.ops import _load
    assert probe_route(Lq, K, 128, _load().plaid_probe_smem_bytes) == route
    g = torch.Generator(device=dev).manual_seed(K + Lq)
    Nq, dim, C, L = 3, 128, 600, 40
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.9
    codes = torch.randint(0, K, (Nq, C, L), generator=g, device=dev,
                          dtype=torch.int32)
    codes[:, : C // 2] = (codes[:, : C // 2, :1] + torch.randint(
        0, 2, (Nq, C // 2, L), generator=g, device=dev,
        dtype=torch.int32)) % K                  # crowded: distinct codes
    cm = torch.rand((Nq, C, L), generator=g, device=dev) < 0.8
    vm = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    args = (q, qm, cen, codes, cm, vm)
    before = launch_counts()["plaid_probe"]
    got = plaid_probe_scores(*args, t_cs=0.05)
    assert launch_counts()["plaid_probe"] == (before
                                              + KERNELS_A_LAUNCH * launches)
    _probe_hold(got, plaid_probe_scores(*args, t_cs=0.05, impl="ref"))


def test_probe_kernel_routes_agree_where_both_serve(dev):
    """At K = 1,024 and Lq = 128 both routes serve: four launches of 32
    query tokens with the table in shared memory (``chunk=32``), or one
    with the table in device memory; each held to the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    Nq, Lq, dim, K, C, L = 3, 128, 128, 1024, 500, 33
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.9
    codes = torch.randint(0, K, (Nq, C, L), generator=g, device=dev,
                          dtype=torch.int32)
    cm = torch.rand((Nq, C, L), generator=g, device=dev) < 0.8
    vm = torch.rand((Nq, C), generator=g, device=dev) < 0.9
    args = (q, qm, cen, codes, cm, vm)
    want = plaid_probe_scores(*args, t_cs=0.05, impl="ref")
    for route, chunk in (("smem", 32), ("global", 128), ("global", 64)):
        _probe_hold(plaid_probe_scores(*args, t_cs=0.05, route=route,
                                       chunk=chunk), want)
    with pytest.raises(ValueError):       # a table this wide is refused
        plaid_probe_scores(*args, t_cs=0.05, route="smem")


def test_odd_widths_and_misaligned_queries_are_served(dev):
    """``maxsim_rerank`` (gathered and indexed) at dim 30: zero-padded to
    32 and served; ``dequant_score`` with a contiguous q at a 4-byte
    offset: copied and served. Each equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(30)
    q = _unit(g, (2, 5, 30), dev)
    qm = torch.ones((2, 5), dtype=torch.bool, device=dev)
    d = _unit(g, (2, 4, 6, 30), dev)
    dm = torch.rand((2, 4, 6), generator=g, device=dev) < 0.8
    torch.testing.assert_close(maxsim_rerank(q, qm, d, dm),
                               maxsim_rerank(q, qm, d, dm, impl="ref"),
                               rtol=1e-5, atol=1e-4)
    store, smask = d[0], dm[0]
    cand = torch.tensor([[0, 3, 2], [1, 1, 0]], device=dev)
    cmask = torch.tensor([[True, True, False], [True, False, True]],
                         device=dev)
    torch.testing.assert_close(
        maxsim_rerank_indexed(q, qm, store, smask, cand, cmask),
        maxsim_rerank_indexed(q, qm, store, smask, cand, cmask, impl="ref"),
        rtol=1e-5, atol=1e-4)
    bits, dim, M, Lq = 2, 64, 40, 7
    flat = torch.randn(Lq * dim + 1, generator=g, device=dev)
    qd = flat[1:].view(Lq, dim)
    assert qd.is_contiguous() and qd.data_ptr() % 16
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (M, dim * bits // 32),
                          generator=g, device=dev, dtype=torch.int32)
    ids = torch.randint(0, 8, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    cen = _unit(g, (8, dim), dev)
    vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.1
    torch.testing.assert_close(
        dequant_score(words, ids, cen, vals, qd, bits=bits),
        dequant_score(words, ids, cen, vals, qd, bits=bits, impl="ref"),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dim", [128, 64])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("S", [1024, 37])
def test_packed_kernel_design_cases(dev, bits, S, dim):
    """The tensor-core design at Ld = 129: a full slate (S = 1,024) and a
    ragged one (S not a multiple of the block's 8 candidates), about a
    fifth of the candidates fully masked, docs of every valid length (tiles
    cut inside and across candidates), masked query tokens; the model's
    width (128, compiled in) and another (64, taken at run time); to
    rtol 1e-5, atol 1e-5 with all-masked candidates exactly 0."""
    g = torch.Generator(device=dev).manual_seed(S + bits + dim)
    Nq, Lq, K, Ld = 4, 32, 256, 129
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.9
    W = dim * bits // 32
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (Nq, S, Ld, W), generator=g,
                      device=dev, dtype=torch.int32)
    ids = torch.randint(0, K, (Nq, S, Ld), generator=g, device=dev,
                        dtype=torch.int32)
    n_valid = torch.randint(0, Ld + 1, (Nq, S, 1), generator=g, device=dev)
    dm = torch.arange(Ld, device=dev) < n_valid
    dm &= torch.rand((Nq, S, 1), generator=g, device=dev) < 0.8
    vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.1
    got = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits)
    want = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits,
                                impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (got[~dm.any(-1)] == 0).all()


@pytest.mark.parametrize("Lq,bits,dim,Ld", [
    (128, 4, 128, 509),          # one window of 256 tokens a candidate ...
    (128, 4, 128, 512),          # ... two full windows,
    (300, 4, 128, 512),          # a long query on an unpooled document,
    (128, 4, 128, 7038),         # Ld past the old shared-memory limits
    (128, 2, 128, 7678),
    (32, 2, 64, 8192),           # past the old 16-bit token index
    (32, 4, 136, 16),            # dim past 128: two slabs, the last ragged
    (128, 2, 256, 129),          # two full slabs
    (40, 4, 200, 300),           # a ragged slab beside two windows
])
def test_packed_kernel_limits(dev, Lq, bits, dim, Ld):
    """Past the limits the kernel had before its windows (Ld) and slabs
    (dim): every case launches once a chunk of 128 query tokens and
    agrees with the plain version to rtol 1e-5, atol 1e-5."""
    g = torch.Generator(device=dev).manual_seed(Ld)
    Nq, S, K = 1, 9, 64
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (Nq, S, Ld, dim * bits // 32),
                      generator=g, device=dev, dtype=torch.int32)
    ids = torch.randint(0, K, (Nq, S, Ld), generator=g, device=dev,
                        dtype=torch.int32)
    dm = torch.rand((Nq, S, Ld), generator=g, device=dev) < 0.9
    vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.1
    args = (q, qm, w, ids, dm, cen, vals)
    before = launch_counts()["maxsim_packed"]
    got = maxsim_packed_rerank(*args, bits=bits)
    assert launch_counts()["maxsim_packed"] == before + -(-Lq // 128)
    torch.testing.assert_close(
        got, maxsim_packed_rerank(*args, bits=bits, impl="ref"),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim,Ld", [(256, 129), (768, 129), (128, 12000),
                                    (128, 20000)])
@pytest.mark.parametrize("bits", [2, 4])
def test_packed_kernel_wide_and_long(dev, bits, dim, Ld):
    """The shapes the kernel took only after its windows and slabs: dim
    256 and 768 at Ld 129, Ld 12,000 and 20,000 at dim 128, a path-like
    slate (32 query tokens, S = 16, about a third of each document
    valid, one candidate fully masked) to rtol 1e-5, atol 1e-5."""
    g = torch.Generator(device=dev).manual_seed(dim + Ld + bits)
    Nq, Lq, S, K = 2, 32, 16, 256
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.9
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (Nq, S, Ld, dim * bits // 32),
                      generator=g, device=dev, dtype=torch.int32)
    ids = torch.randint(0, K, (Nq, S, Ld), generator=g, device=dev,
                        dtype=torch.int32)
    dm = torch.rand((Nq, S, Ld), generator=g, device=dev) < 0.35
    dm[0, 3] = False
    vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.1
    got = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits)
    want = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits,
                                impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got[0, 3]) == 0.0


@pytest.mark.parametrize("Nq,Lq,dim,Nd,Ld", [
    (5, 32, 128, 300, 129),      # several doc runs, tiles across docs
    (3, 40, 64, 17, 20),         # a tile over several docs, Lq = 40
    (2, 8, 128, 1, 64),
    (4, 32, 128, 1000, 1),       # one-token docs: narrow tiles
    (3, 32, 128, 50, 300),       # docs longer than two tiles
    (2, 40, 128, 1, 129),        # Nd = 1: a doc over two tiles
    (33, 32, 128, 700, 129),     # nine query groups (Nq * Lq > 128)
    (4, 16, 36, 40, 50),         # dim not a multiple of 8
    (3, 32, 256, 40, 50),        # dim above 132: the f32 body
])
def test_maxsim_kernel_equals_plain(dev, Nq, Lq, dim, Nd, Ld):
    """One launch a call (Lq <= 128), rtol 1e-5 / atol 1e-4 against the
    plain version; a query with no valid token and a doc with none score
    0."""
    g = torch.Generator(device=dev).manual_seed(Nd)
    q, d = _unit(g, (Nq, Lq, dim), dev), _unit(g, (Nd, Ld, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.8
    qm[0, :] = False                             # a query with no valid token
    dm = torch.rand((Nd, Ld), generator=g, device=dev) < 0.7
    dm[-1] = False                               # a doc with no valid token
    before = launch_counts()["maxsim"]
    got = maxsim(q, qm, d, dm)
    assert launch_counts()["maxsim"] == before + 1
    want = maxsim(q, qm, d, dm, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert (got[:, -1] == 0).all() and (got[0] == 0).all()


@pytest.mark.parametrize("case", ["ragged docs", "long query",
                                  "masked runs", "short docs",
                                  "sparse mask"])
def test_maxsim_kernel_design_cases(dev, case):
    """The tensor-core design on what its tiles must get right: docs of
    every valid length at Ld = 129 (segment maxima across tile and warp
    boundaries), a query of 300 tokens (three launches of at most 128,
    summed), runs of fully masked docs (never listed, scoring 0), docs of
    at most 10 valid rows (many documents a warp and a tile), and 3% of
    rows valid at random (tiles listed over several scans); to rtol 1e-5
    / atol 1e-4."""
    g = torch.Generator(device=dev).manual_seed(11)
    Nq, Lq, dim, Nd, Ld = 6, 32, 128, 500, 129
    if case == "long query":
        Lq = 300
    q, d = _unit(g, (Nq, Lq, dim), dev), _unit(g, (Nd, Ld, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.9
    n_valid = torch.randint(0, (11 if case == "short docs" else Ld + 1),
                            (Nd, 1), generator=g, device=dev)
    dm = torch.arange(Ld, device=dev) < n_valid
    if case == "masked runs":
        dm[100:200] = False
        dm[300:303, 5:] = False
    if case == "sparse mask":
        dm = torch.rand((Nd, Ld), generator=g, device=dev) < 0.03
    before = launch_counts()["maxsim"]
    got = maxsim(q, qm, d, dm)
    assert launch_counts()["maxsim"] == before + -(-Lq // 128)
    torch.testing.assert_close(got, maxsim(q, qm, d, dm, impl="ref"),
                               rtol=1e-5, atol=1e-4)
    assert (got[:, ~dm.any(1)] == 0).all()


@pytest.mark.parametrize("Lq,Ld,dim", [
    (32, 50, 128),              # QR = 32
    (32, 129, 128),             # the paths' widths
    (64, 129, 128),             # QR = 64
    (100, 129, 128),            # QR = 128
    (300, 129, 128),            # three launches of at most 128 tokens
    (32, 1, 128),               # one-token docs: many documents a tile
    (32, 300, 128),             # docs longer than two tiles
    (40, 129, 96),              # a generic width
    (32, 50, 256),              # above dim 132: the f32 body
])
def test_maxsim_rerank_kernel_equals_plain(dev, Lq, Ld, dim):
    """ceil(Lq / 128) launches a call, rtol 1e-5 / atol 1e-4 against the
    plain version at S = 37 (not a multiple of 8); a fully masked
    candidate scores 0."""
    g = torch.Generator(device=dev).manual_seed(5 + Lq + Ld + dim)
    Nq, S = 4, 37
    q, d = _unit(g, (Nq, Lq, dim), dev), _unit(g, (Nq, S, Ld, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.8
    dm = torch.rand((Nq, S, Ld), generator=g, device=dev) < 0.5
    dm[0, 0] = False                             # a fully masked candidate
    before = launch_counts()["maxsim_rerank"]
    got = maxsim_rerank(q, qm, d, dm)
    assert launch_counts()["maxsim_rerank"] == before + -(-Lq // 128)
    want = maxsim_rerank(q, qm, d, dm, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert float(got[0, 0]) == 0.0


@pytest.mark.parametrize("Lq,dim", [(32, 128), (150, 128), (32, 96),
                                    (32, 256)])
def test_maxsim_rerank_indexed_kernel_equals_plain(dev, Lq, dim):
    """Candidates read from a store in place: rtol 1e-5 / atol 1e-4
    against the plain version (the store's rows gathered); invalid
    candidates hold ids outside the store (-1, Nd, 2^40) and score 0
    unread, and a store document without a valid row scores 0."""
    g = torch.Generator(device=dev).manual_seed(Lq + dim)
    Nq, S, Nd, Ld = 5, 300, 700, 129
    q, d = _unit(g, (Nq, Lq, dim), dev), _unit(g, (Nd, Ld, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.9
    n_valid = torch.randint(0, Ld + 1, (Nd, 1), generator=g, device=dev)
    dm = torch.arange(Ld, device=dev) < n_valid
    dm[3] = False                                # a doc with no valid row
    cand = torch.randint(0, Nd, (Nq, S), generator=g, device=dev)
    cand[:, 0] = 3
    cm = torch.rand((Nq, S), generator=g, device=dev) < 0.8
    cm[:, 0] = True
    cm[-1] = False                               # no valid candidate
    junk = torch.tensor([-1, Nd, 2 ** 40], device=dev)
    cand = torch.where(cm, cand, junk[torch.arange(S, device=dev) % 3])
    before = launch_counts()["maxsim_rerank"]
    got = maxsim_rerank_indexed(q, qm, d, dm, cand, cm)
    assert launch_counts()["maxsim_rerank"] == before + -(-Lq // 128)
    want = maxsim_rerank_indexed(q, qm, d, dm, cand, cm, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert (got[~cm] == 0).all() and (got[:, 0] == 0).all()


@pytest.mark.parametrize("B,N,K,dim,dtype", [
    (1, 257, 32, 128, torch.float32),      # the reference's standalone shape
    (1, 100, 8, 64, torch.bfloat16),
    (6, 256, 129, 128, torch.float32),     # k-means pooling at f=2
    (3, 70, 200, 32, torch.float32),       # K above one pass of 136
    (4, 256, 136, 128, torch.float32),     # K exactly one pass
    (4, 250, 200, 128, torch.bfloat16),    # two passes, N % 16 != 0
    (4, 256, 5, 128, torch.float32),       # K below one n-tile of 8
    (3, 513, 257, 128, torch.float32),     # k-means at N = 512, 3 row blocks
    (2, 40, 20, 36, torch.float32),        # dim not a multiple of 8
    (2, 60, 30, 200, torch.float32),       # dim above one register chunk
])
def test_kmeans_assign_kernel_equals_plain(dev, B, N, K, dim, dtype):
    """One launch a call; ids equal to the plain version's except where
    the top two sims lie within 1e-5, best sims to 1e-5; a document with
    every cluster masked gets index 0 and -inf."""
    g = torch.Generator(device=dev).manual_seed(N + K)
    x = torch.randn((B, N, dim), generator=g, device=dev).to(dtype)
    c = torch.randn((B, K, dim), generator=g, device=dev).to(dtype)
    km = torch.rand((B, K), generator=g, device=dev) < 0.7
    if B == 1:                                   # the reference's contract
        x, c, km = x[0], c[0], km[0]
    else:
        km[0] = False                            # every cluster masked
    before = launch_counts()["kmeans_assign"]
    a, s = kmeans_assign(x, c, km)
    assert launch_counts()["kmeans_assign"] == before + 1
    ar, sr = kmeans_assign(x, c, km, impl="ref")
    sim = torch.matmul(x.float(), c.float().transpose(-1, -2)).masked_fill(
        ~km[..., None, :], float("-inf"))
    top2 = sim.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5
    assert not ((a != ar) & ~near).any()
    torch.testing.assert_close(s, sr, rtol=1e-5, atol=1e-5)
    if B > 1:                                    # all masked: index 0, -inf
        assert (a[0] == 0).all() and torch.isinf(s[0]).all()


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("M,dim,Lq", [
    (100, 128, 16), (300, 64, 32), (5000, 128, 32),
    (1001, 128, 1),             # M not a multiple of the 16-row tile
    (777, 96, 100),             # a generic width, four passes of 32 tokens
    (333, 128, 300),            # two kernels in one call (256 + 44 at b = 2)
    (64, 256, 40),              # tensor cores at b = 2, f32 body at b = 4
    (100, 512, 8),              # too wide for the tiles: the f32 body
])
def test_dequant_score_kernel_equals_plain(dev, bits, M, dim, Lq):
    g = torch.Generator(device=dev).manual_seed(M + bits)
    K = 16
    W = dim * bits // 32
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (M, W), generator=g,
                          device=dev, dtype=torch.int32)
    ids = torch.randint(0, K, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    cen = _unit(g, (K, dim), dev)
    vals = torch.randn((dim, 1 << bits), generator=g, device=dev) * 0.05
    q = _unit(g, (Lq, dim), dev)
    before = launch_counts()["dequant_score"]
    got = dequant_score(words, ids, cen, vals, q, bits=bits)
    assert launch_counts()["dequant_score"] == before + 1
    want = dequant_score(words, ids, cen, vals, q, bits=bits, impl="ref")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_wrappers_reject_bad_inputs(dev):
    x = torch.randn((2, 8, 16), device=dev)
    mask = torch.ones((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ward_assign(x, mask, 2)
    q = torch.randn((1, 4, 32), device=dev)
    with pytest.raises(TypeError):
        plaid_probe_scores(q.double(), torch.ones((1, 4), dtype=torch.bool,
                                                  device=dev),
                           torch.randn((8, 32), device=dev),
                           torch.zeros((1, 3, 2), dtype=torch.int32,
                                       device=dev),
                           torch.ones((1, 3, 2), dtype=torch.bool, device=dev),
                           torch.ones((1, 3), dtype=torch.bool, device=dev),
                           t_cs=0.3)
    with pytest.raises(TypeError):
        kmeans_assign(x[0], torch.randn((4, 16), device=dev),
                      torch.ones(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):                # W does not match dim
        dequant_score(torch.zeros((3, 5), dtype=torch.int32, device=dev),
                      torch.zeros(3, dtype=torch.int32, device=dev),
                      torch.randn((4, 32), device=dev),
                      torch.randn((32, 4), device=dev),
                      torch.randn((2, 32), device=dev), bits=2)
    # dim not a multiple of 4: zero-padded and served, equal to the plain
    # version
    d = torch.randn((3, 5, 30), device=dev)
    q30 = torch.randn((1, 4, 30), device=dev)
    qm30 = torch.ones((1, 4), dtype=torch.bool, device=dev)
    dm30 = torch.ones((3, 5), dtype=torch.bool, device=dev)
    torch.testing.assert_close(maxsim(q30, qm30, d, dm30),
                               maxsim(q30, qm30, d, dm30, impl="ref"),
                               rtol=1e-5, atol=1e-4)


FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,causal", [
    (2, 16, 8, 300, 300, 64, True),       # GQA group 2, ragged tails
    (1, 8, 8, 256, 256, 128, True),       # MHA, dh 128
    (2, 4, 1, 100, 333, 64, False),       # group 4, non-causal
    (1, 4, 2, 70, 200, 128, True),        # Sq < Skv: bottom-right anchor
    (1, 5, 1, 1, 77, 64, True),           # one query row (decode shape)
    (2, 8, 2, 333, 517, 128, True),       # ragged Sq < Skv at dh 128
    (1, 8, 4, 517, 333, 128, True),       # ragged Sq > Skv at dh 128
    (1, 16, 2, 300, 300, 112, True),      # Kimi K2's dh 112, group 8
    (2, 8, 8, 129, 200, 112, True),       # ragged Sq < Skv at dh 112
    (1, 8, 1, 200, 129, 112, False),      # group 8, non-causal, dh 112
])
def test_flash_attention_kernel_equals_plain(dev, dtype, B, H, KV, Sq, Skv,
                                             dh, causal):
    g = torch.Generator(device=dev).manual_seed(Sq * 7 + Skv)
    q = torch.randn((B, H, Sq, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((B, KV, Skv, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((B, KV, Skv, dh), generator=g, device=dev).to(dtype)
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention(q, k, v, causal=causal, impl="ref")
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_attention_bf16_at_the_lm_shape(dev):
    """Qwen3-0.6B's per-layer prefill shape (8 x 2,048 tokens, 16 heads
    over 8 kv heads, dh 64) in the model's [B, S, H, dh] layout, on the
    tensor-core body."""
    g = torch.Generator(device=dev).manual_seed(2048)
    q, k, v = (torch.randn((8, 2048, n, 64), generator=g, device=dev)
               .bfloat16().transpose(1, 2) for n in (16, 8, 8))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q, k, v, causal=True, impl="ref")
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("B", [1, 2])
def test_flash_attention_takes_the_models_strided_heads(dev, B):
    """The model hands [B, S, H, dh] projections transposed to
    [B, H, S, dh]; at B = 1 their [B*H, S, dh] reshape is a strided view."""
    g = torch.Generator(device=dev).manual_seed(B)
    q, k, v = (torch.randn((B, 130, n, 64), generator=g, device=dev)
               .bfloat16().transpose(1, 2) for n in (16, 8, 8))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q, k, v, causal=True, impl="ref")
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])
    # written in [B, S, H, dh] memory, as the output projection reads it
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_any_aligned_strides(dev, dtype):
    """q, k, v split from one fused [B, S, (H + 2 KV) dh] projection (rows
    (H + 2 KV) dh apart), and a [BH, S, dh] q whose heads are not
    contiguous: the kernel reads them where they lie."""
    B, S, H, KV, dh = 2, 150, 8, 2, 64
    g = torch.Generator(device=dev).manual_seed(11)
    qkv = torch.randn((B, S, (H + 2 * KV) * dh), generator=g,
                      device=dev).to(dtype)
    q, k, v = qkv.split([H * dh, KV * dh, KV * dh], dim=-1)
    q, k, v = (t.reshape(B, S, -1, dh).transpose(1, 2) for t in (q, k, v))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q, k, v, causal=True, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    qh = torch.randn((S, B * H, dh), generator=g, device=dev).to(dtype)
    kh = torch.randn((B * KV, S, dh), generator=g, device=dev).to(dtype)
    got = flash_attention_bh(qh.transpose(0, 1), kh, kh, causal=False)
    want = flash_attention_bh(qh.transpose(0, 1), kh, kh, causal=False,
                              impl="ref")
    assert got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rows_without_columns_are_zero(dev, dtype):
    """Sq > Skv: rows 0 .. Sq - Skv - 1 see no kv column and output 0."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((6, 200, 64), generator=g, device=dev).to(dtype)
    k = torch.randn((3, 70, 64), generator=g, device=dev).to(dtype)
    v = torch.randn((3, 70, 64), generator=g, device=dev).to(dtype)
    got = flash_attention_bh(q, k, v, causal=True)
    want = flash_attention_bh(q, k, v, causal=True, impl="ref")
    assert not got[:, :130].any() and not want[:, :130].any()
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_attention_rejects_what_it_does_not_take(dev):
    q = torch.randn((4, 8, 32), device=dev)
    with pytest.raises(ValueError):               # dh 32
        flash_attention_bh(q, q[:2], q[:2])
    q = torch.randn((4, 8, 64), device=dev)
    with pytest.raises(TypeError):                # mixed dtypes
        flash_attention_bh(q, q[:2].bfloat16(), q[:2].bfloat16())
    with pytest.raises(ValueError):               # dh not unit stride
        flash_attention_bh(torch.randn((4, 64, 8), device=dev)
                           .transpose(1, 2), q[:2], q[:2])
    with pytest.raises(ValueError):               # rows not 16-byte aligned
        flash_attention_bh(torch.randn((4, 8, 65), device=dev)[..., :64],
                           q[:2], q[:2])
