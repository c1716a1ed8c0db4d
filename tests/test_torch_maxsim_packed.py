"""Packed codes and the plain version of the port's ``maxsim_packed``
kernel against the JAX reference (``repro.core.quantization`` and
``repro.kernels.maxsim_packed.ref``).

Packing is integer work: words and codes must be equal. Scores agree
to 1e-5 (dot products and sums run in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels.maxsim_packed.ref import maxsim_packed_rerank_ref as j_rr
from repro_torch.core import quantization as tq
from repro_torch.kernels import launch_counts
from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
from repro_torch.kernels.maxsim.ref import tf32_split_ref
from repro_torch.kernels.maxsim_packed.ref import maxsim_packed_3xtf32_ref


@pytest.mark.parametrize("bits", [2, 4])
def test_pack_unpack_equal_reference(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, size=(37, 64)).astype(np.int32)
    jw = np.asarray(jq.pack_codes(jnp.asarray(codes), bits))
    tw = tq.pack_codes(torch.from_numpy(codes), bits)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    back = tq.unpack_codes(tw, bits, 64).numpy()
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(
        back, np.asarray(jq.unpack_codes(jnp.asarray(jw), bits, 64)))


def _inputs(seed, bits, Nq=3, Lq=5, S=7, Ld=6, dim=32, K=20):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Nq, Lq, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qm = rng.random((Nq, Lq)) < 0.8
    W = dim * bits // 32
    words = rng.integers(0, 2 ** 32, size=(Nq, S, Ld, W),
                         dtype=np.uint64).astype(np.uint32)
    ids = rng.integers(0, K, size=(Nq, S, Ld)).astype(np.int32)
    dm = rng.random((Nq, S, Ld)) < 0.6
    cen = rng.normal(size=(K, dim)).astype(np.float32)
    cen /= np.linalg.norm(cen, axis=-1, keepdims=True)
    vals = (rng.normal(size=(dim, 1 << bits)) * 0.1).astype(np.float32)
    return q, qm, words, ids, dm, cen, vals


def _both(args, bits, impl="auto"):
    q, qm, words, ids, dm, cen, vals = args
    want = np.asarray(j_rr(jnp.asarray(q), jnp.asarray(qm),
                           jnp.asarray(words), jnp.asarray(ids),
                           jnp.asarray(dm), jnp.asarray(cen),
                           jnp.asarray(vals), bits=bits))
    got = maxsim_packed_rerank(
        torch.from_numpy(q), torch.from_numpy(qm),
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(ids),
        torch.from_numpy(dm), torch.from_numpy(cen), torch.from_numpy(vals),
        bits=bits, impl=impl).numpy()
    return got, want


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_plain_matches_reference(seed, bits):
    got, want = _both(_inputs(seed, bits), bits)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 4])
def test_packed_all_masked_and_single_candidate(bits):
    args = list(_inputs(5, bits, S=1))
    got, want = _both(args, bits)                 # a single candidate
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    args[4] = np.zeros_like(args[4])              # every doc token masked
    got, want = _both(args, bits)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


def test_packed_cpu_dispatch_is_the_plain_version():
    args = _inputs(6, 2)
    before = launch_counts()["maxsim_packed"]
    auto, _ = _both(args, 2)
    ref, _ = _both(args, 2, impl="ref")
    np.testing.assert_array_equal(auto, ref)
    assert launch_counts()["maxsim_packed"] == before


def test_tf32_split():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (``cvt.rna.tf32.f32``); hi + lo is within 2^-21 of x relative."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -1.0 - 2 ** -11, 3.14159265, 1e-3, 0.0])
    hi, lo = tf32_split_ref(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(
        hi[:4].numpy(), np.float32([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                    -1.0 - 2 ** -10]))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    hi, lo = tf32_split_ref(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2 ** -21).all()


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_products_match_reference(seed, bits):
    """The kernel's products, hi.hi + hi.lo + lo.hi of TF32 parts, at the
    model's width (dim 128) against the JAX reference to rtol 1e-5,
    atol 1e-5; single-pass TF32 (hi.hi) misses that tolerance."""
    args = _inputs(seed, bits, Lq=32, S=16, Ld=40, dim=128)
    want = _both(args, bits)[1]
    t = [torch.from_numpy(a) for a in args]
    t[2] = torch.from_numpy(args[2].view(np.int32))
    got = maxsim_packed_3xtf32_ref(*t, bits=bits).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    one = maxsim_packed_3xtf32_ref(*t, bits=bits, passes=1).numpy()
    assert not np.allclose(one, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [2, 4])
def test_3xtf32_slabs_match_reference_wide_and_long(bits):
    """The kernel's slab order (128 dims a step, partial sums added in
    order) at dim 256 and Ld 9,000, past the widths the kernel took
    before its windows and slabs, against the JAX reference to rtol 1e-5,
    atol 1e-5."""
    args = _inputs(bits + 7, bits, Nq=1, Lq=32, S=2, Ld=9000, dim=256)
    want = _both(args, bits)[1]
    t = [torch.from_numpy(a) for a in args]
    t[2] = torch.from_numpy(args[2].view(np.int32))
    got = maxsim_packed_3xtf32_ref(*t, bits=bits).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
