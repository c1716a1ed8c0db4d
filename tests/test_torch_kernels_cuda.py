"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips where no CUDA device exists (the
fixture decides at run time). Run on a card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.

Tolerances: Ward assignments equal; probe -inf slots equal and finite
scores to 1e-5; packed rerank scores to 1e-5; the f32 MaxSim kernels to
rtol 1e-5, atol 1e-4 (f32 dot products and sums in another order);
k-means assignment ids equal except where the top two sims lie within
1e-5 (f32 dot products in another order), best sims to 1e-5; dequantize
+ score to atol 1e-4, the reference test's tolerance.
"""
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.kernels.maxsim.ops import maxsim, maxsim_rerank
from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores
from repro_torch.kernels.quant.ops import dequant_score
from repro_torch.kernels.ward_pool.ops import ward_assign

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _unit(g, shape, dev):
    x = torch.randn(shape, generator=g, device=dev)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("N,d", [(20, 16), (256, 128), (300, 128)])
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


def test_probe_kernel_equals_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    Nq, Lq, dim, K, C, L = 4, 32, 128, 256, 700, 50
    q, cen = _unit(g, (Nq, Lq, dim), dev), _unit(g, (K, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.8
    codes = torch.randint(0, K, (Nq, C, L), generator=g, device=dev,
                          dtype=torch.int32)
    cm = torch.rand((Nq, C, L), generator=g, device=dev) < 0.7
    vm = torch.rand((Nq, C), generator=g, device=dev) < 0.8
    got = plaid_probe_scores(q, qm, cen, codes, cm, vm, t_cs=0.1)
    want = plaid_probe_scores(q, qm, cen, codes, cm, vm, t_cs=0.1, impl="ref")
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 4])
def test_packed_kernel_equals_plain(dev, bits):
    g = torch.Generator(device=dev).manual_seed(bits)
    Nq, Lq, dim, K, S, L = 4, 32, 128, 256, 37, 50
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
    got = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits)
    want = maxsim_packed_rerank(q, qm, w, ids, dm, cen, vals, bits=bits,
                                impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got[0, 0]) == 0.0


@pytest.mark.parametrize("Nq,Lq,dim,Nd,Ld", [
    (5, 32, 128, 300, 129),      # several doc blocks, three token chunks
    (3, 40, 64, 17, 20),         # two query tiles, a ragged doc block
    (2, 8, 128, 1, 64),
])
def test_maxsim_kernel_equals_plain(dev, Nq, Lq, dim, Nd, Ld):
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


def test_maxsim_rerank_kernel_equals_plain(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    Nq, Lq, dim, S, Ld = 4, 32, 128, 37, 50
    q, d = _unit(g, (Nq, Lq, dim), dev), _unit(g, (Nq, S, Ld, dim), dev)
    qm = torch.rand((Nq, Lq), generator=g, device=dev) < 0.8
    dm = torch.rand((Nq, S, Ld), generator=g, device=dev) < 0.5
    dm[0, 0] = False                             # a fully masked candidate
    before = launch_counts()["maxsim_rerank"]
    got = maxsim_rerank(q, qm, d, dm)
    assert launch_counts()["maxsim_rerank"] == before + 1
    want = maxsim_rerank(q, qm, d, dm, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert float(got[0, 0]) == 0.0


@pytest.mark.parametrize("B,N,K,dim,dtype", [
    (1, 257, 32, 128, torch.float32),      # the reference's standalone shape
    (1, 100, 8, 64, torch.bfloat16),
    (6, 256, 129, 128, torch.float32),     # k-means pooling at f=2
    (3, 70, 200, 32, torch.float32),       # K above one centroid chunk
])
def test_kmeans_assign_kernel_equals_plain(dev, B, N, K, dim, dtype):
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
@pytest.mark.parametrize("M,dim,Lq", [(100, 128, 16), (300, 64, 32),
                                      (5000, 128, 32)])
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
    d = torch.randn((3, 5, 30), device=dev)      # dim not a multiple of 4
    with pytest.raises(TypeError):
        kmeans_assign(x[0], torch.randn((4, 16), device=dev),
                      torch.ones(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):                # W does not match dim
        dequant_score(torch.zeros((3, 5), dtype=torch.int32, device=dev),
                      torch.zeros(3, dtype=torch.int32, device=dev),
                      torch.randn((4, 32), device=dev),
                      torch.randn((32, 4), device=dev),
                      torch.randn((2, 32), device=dev), bits=2)
    with pytest.raises(ValueError):
        maxsim(torch.randn((1, 4, 30), device=dev),
               torch.ones((1, 4), dtype=torch.bool, device=dev), d,
               torch.ones((3, 5), dtype=torch.bool, device=dev))
