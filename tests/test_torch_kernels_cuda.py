"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips where no CUDA device exists (the
fixture decides at run time). Run on a card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.

Tolerances: Ward assignments equal; probe -inf slots equal and finite
scores to 1e-5; packed rerank scores to 1e-5; the f32 MaxSim kernels to
rtol 1e-5, atol 1e-4 (f32 dot products and sums in another order).
"""
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.maxsim.ops import maxsim, maxsim_rerank
from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores
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
    with pytest.raises(ValueError):
        maxsim(torch.randn((1, 4, 30), device=dev),
               torch.ones((1, 4), dtype=torch.bool, device=dev), d,
               torch.ones((3, 5), dtype=torch.bool, device=dev))
