"""Query-token chunking of the ``plaid_probe`` and ``maxsim_packed``
wrappers, on the CPU with the port's plain versions.

A launch of either kernel takes at most ``MAX_LQ`` query tokens; the
wrappers split a longer query into chunks, launch once per chunk and sum
the partial scores. Both scores are sums of per-query-token terms (a
masked token adds 0, an invalid probe candidate is -inf in every part),
so the composition is exact up to f32 summation order. Here it runs the
plain versions chunk by chunk at Lq = 300 and is held against the JAX
references over the whole query: -inf slots equal, finite scores to
rtol = atol = 1e-5 (dot products and sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.maxsim_packed.ref import maxsim_packed_rerank_ref as j_rr
from repro.kernels.plaid_probe.ref import plaid_probe_ref as j_probe
from repro_torch.kernels import query_chunks, sum_over_query_chunks
from repro_torch.kernels.maxsim_packed import ops as packed_ops
from repro_torch.kernels.maxsim_packed.ref import maxsim_packed_rerank_ref
from repro_torch.kernels.plaid_probe import ops as probe_ops
from repro_torch.kernels.plaid_probe.ref import plaid_probe_ref

LQ = 300


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _counting(fn, calls):
    def wrapped(q, qm):
        calls.append(q.shape[1])
        return fn(q, qm)
    return wrapped


@pytest.mark.parametrize("Lq,want", [
    (1, [(0, 1)]), (32, [(0, 32)]), (128, [(0, 128)]),
    (129, [(0, 128), (128, 129)]),
    (300, [(0, 128), (128, 256), (256, 300)]),
])
def test_query_chunks_cover_the_query(Lq, want):
    assert query_chunks(Lq, 128) == want


@pytest.mark.parametrize("Lq", [1, 32, 128])
def test_one_chunk_passes_the_tensors_through(Lq):
    q, qm = torch.zeros((2, Lq, 4)), torch.ones((2, Lq), dtype=torch.bool)
    seen = []

    def fn(a, b):
        seen.append((a, b))
        return torch.zeros(2)
    sum_over_query_chunks(fn, q, qm, 128)
    assert len(seen) == 1 and seen[0][0] is q and seen[0][1] is qm


@pytest.mark.parametrize("t_cs", [0.0, 0.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_probe_chunks_match_the_reference(seed, t_cs):
    rng = np.random.default_rng(seed)
    Nq, dim, K, C, L = 2, 16, 24, 64, 9    # C: the reference scans 32 a block
    q = _unit(rng, (Nq, LQ, dim))
    qm = rng.random((Nq, LQ)) < 0.8
    qm[0, 128:256] = False                  # a whole chunk masked
    cen = _unit(rng, (K, dim))
    codes = rng.integers(0, K, size=(Nq, C, L)).astype(np.int32)
    cmask = rng.random((Nq, C, L)) < 0.6
    vmask = rng.random((Nq, C)) < 0.8
    want = np.asarray(j_probe(*(jnp.asarray(a) for a in (
        q, qm, cen, codes, cmask, vmask)), t_cs=t_cs))
    rest = [torch.from_numpy(a) for a in (cen, codes, cmask, vmask)]
    calls = []
    got = sum_over_query_chunks(
        _counting(lambda a, b: plaid_probe_ref(a, b, *rest, t_cs=t_cs),
                  calls),
        torch.from_numpy(q), torch.from_numpy(qm), probe_ops.MAX_LQ).numpy()
    assert calls == [128, 128, 44]
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 4])
def test_packed_chunks_match_the_reference(bits):
    rng = np.random.default_rng(bits)
    Nq, S, Ld, dim, K = 2, 7, 6, 32, 20
    q = _unit(rng, (Nq, LQ, dim))
    qm = rng.random((Nq, LQ)) < 0.8
    W = dim * bits // 32
    words = rng.integers(0, 2 ** 32, size=(Nq, S, Ld, W),
                         dtype=np.uint64).astype(np.uint32)
    ids = rng.integers(0, K, size=(Nq, S, Ld)).astype(np.int32)
    dm = rng.random((Nq, S, Ld)) < 0.6
    dm[0, 0] = False                        # a candidate with no valid token
    cen = _unit(rng, (K, dim))
    vals = (rng.normal(size=(dim, 1 << bits)) * 0.1).astype(np.float32)
    want = np.asarray(j_rr(*(jnp.asarray(a) for a in (
        q, qm, words, ids, dm, cen, vals)), bits=bits))
    rest = [torch.from_numpy(a) for a in (words.view(np.int32), ids, dm, cen,
                                          vals)]
    calls = []
    got = sum_over_query_chunks(
        _counting(lambda a, b: maxsim_packed_rerank_ref(a, b, *rest,
                                                        bits=bits), calls),
        torch.from_numpy(q), torch.from_numpy(qm),
        packed_ops.MAX_LQ).numpy()
    assert calls == [128, 128, 44]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[0, 0] == 0.0


def _probe_smem_bytes(lq, K, dim):
    """``csrc/plaid_probe.cu`` ``plaid_probe_smem_bytes``: the larger of
    the table kernel's centroid tile (32 rows of dim + 1 floats) and the
    probe kernel's table ((K + 2) x 32 R floats, rounded to 16 bytes)
    plus its eight warps' buffers (146 vectors of 16 bytes each)."""
    R = 1 if lq <= 32 else -(-lq // 32)
    table = (((K + 2) * 32 * R + 3) & ~3) * 4
    return max(4 * 32 * (dim + 1), table + 8 * 146 * 16)


@pytest.mark.parametrize("Lq,K,want", [
    (32, 256, "smem"),                 # the main path
    (32, 1668, "smem"),                # the last K whose table fits
    (32, 1669, "global"),
    (32, 8192, "global"),              # PLAID's K at ~3.6e5 vectors
    (32, 16384, "global"),
    (64, 833, "smem"),
    (64, 834, "global"),
    (128, 415, "smem"),
    (128, 416, "global"),              # narrower chunks were slower
    (128, 1024, "global"),
    (300, 415, "smem"),                # chunks of 128 query tokens
    (300, 512, "global"),
])
def test_probe_route_choice(Lq, K, want):
    assert probe_ops.probe_route(Lq, K, 128, _probe_smem_bytes) == want
