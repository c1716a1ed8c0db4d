"""The ``dequant_score`` kernel's plain version (``kernels/quant``)
against the JAX wrapper (the Pallas kernel in interpret mode) and the
JAX reference ``dequant_score_ref``, at the reference test's shapes
(``tests/test_kernels.py``) with the reference's codec and codes.

Tolerance: atol 1e-4, the reference test's own (f32 dot products in
another order), also for the kernel's 3xTF32 products
(``dequant_score_3xtf32_ref``), where one TF32 pass misses it. Packed
words cross as the uint32 bits viewed as int32, as the port holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import encode, train_codec
from repro.kernels.quant.ops import dequant_score as j_dequant_score
from repro.kernels.quant.ref import dequant_score_ref as j_dequant_score_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.quant.ops import dequant_score
from repro_torch.kernels.quant.ref import dequant_score_3xtf32_ref


def _case(m, dim, lq, bits):
    rng = np.random.default_rng(m + bits)
    vecs = rng.normal(size=(m, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    cents = rng.normal(size=(16, dim)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=-1, keepdims=True)
    codec = train_codec(jnp.asarray(vecs), jnp.asarray(cents), bits=bits)
    ids, words = encode(codec, jnp.asarray(vecs))
    q = jnp.asarray(rng.normal(size=(lq, dim)), jnp.float32)
    return codec, ids, words, q


def _port_args(codec, ids, words, q):
    return (torch.from_numpy(np.asarray(words).view(np.int32).copy()),
            torch.from_numpy(np.asarray(ids, np.int32).copy()),
            torch.tensor(np.asarray(codec.centroids)),
            torch.tensor(np.asarray(codec.values)),
            torch.tensor(np.asarray(q)))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m,dim,lq", [(100, 128, 16), (300, 64, 32)])
def test_dequant_score_plain_matches_jax(m, dim, lq, bits):
    codec, ids, words, q = _case(m, dim, lq, bits)
    jout = j_dequant_score(words, ids, codec.centroids, codec.values, q,
                           bits=bits, block_m=64)              # interpret
    rows = jnp.take(codec.centroids, ids, axis=0)
    jref = j_dequant_score_ref(words, rows, codec.values, q, bits=bits)
    before = launch_counts()["dequant_score"]
    got = dequant_score(*_port_args(codec, ids, words, q), bits=bits)
    assert launch_counts()["dequant_score"] == before        # CPU: plain
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, lq)
    for want in (jout, jref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("bits", [2, 4])
def test_dequant_score_rows_are_unit_reconstructions(bits):
    """Each row's best sim over the query equals its decoded row scored
    by the codec's own decode (``core/quantization.py``), and a query of
    that decoded row scores 1."""
    from repro_torch.core.quantization import ResidualCodec, decode
    codec, ids, words, q = _case(64, 32, 8, bits)
    w, i, cen, vals, tq = _port_args(codec, ids, words, q)
    tcodec = ResidualCodec(cen, torch.tensor(np.asarray(codec.cutoffs)),
                           vals, bits)
    v = decode(tcodec, i, w)                                    # [M, dim]
    np.testing.assert_allclose(dequant_score(w, i, cen, vals, tq,
                                             bits=bits).numpy(),
                               (v @ tq.T).numpy(), atol=1e-5)
    own = dequant_score(w, i, cen, vals, v[:4].contiguous(), bits=bits)
    np.testing.assert_allclose(torch.diagonal(own[:4]).numpy(), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m,dim,lq", [(100, 128, 16), (300, 64, 32),
                                      (70, 96, 1)])
def test_dequant_score_3xtf32_matches_jax(m, dim, lq, bits):
    """The kernel's products (``dequant_score_3xtf32_ref``) against the
    Pallas kernel in interpret mode to atol 1e-4; one TF32 pass misses
    it."""
    codec, ids, words, q = _case(m, dim, lq, bits)
    jout = np.asarray(j_dequant_score(words, ids, codec.centroids,
                                      codec.values, q, bits=bits,
                                      block_m=64))
    args = _port_args(codec, ids, words, q)
    got = dequant_score_3xtf32_ref(*args, bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, lq)
    np.testing.assert_allclose(got.numpy(), jout, atol=1e-4)
    one = dequant_score_3xtf32_ref(*args, bits=bits, passes=1).numpy()
    assert not np.allclose(one, jout, atol=1e-4)
