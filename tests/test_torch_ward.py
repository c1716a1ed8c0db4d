"""The port's plain Ward (``repro_torch.core.ward``) and Ward pooling
against the JAX reference (``repro.core.ward`` / ``repro.core.pooling``).

Inputs are Gaussian with no duplicated tokens: exact duplicates make
zero-distance ties whose order depends on rounding (ROADMAP queue 3).
Assignments and pooled counts must be equal; pooled vectors agree to
1e-5 (segment sums accumulate in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pooling import pool_doc_embeddings as j_pool
from repro.core.ward import ward_cluster_batch as j_ward
from repro_torch.core.pooling import (compact_pooled_flat,
                                      pool_doc_embeddings)
from repro_torch.core.ward import ward_cluster_batch
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ward_pool.ops import ward_assign
from repro_torch.kernels.ward_pool.ref import ward_agree, ward_objective


def _inputs(seed, B=6, N=40, d=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, d)).astype(np.float32)
    n_valid = rng.integers(1, N + 1, size=B)
    mask = np.arange(N)[None, :] < n_valid[:, None]
    return x, mask


@pytest.mark.parametrize("factor", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_ward_assignments_match_reference(seed, factor):
    x, mask = _inputs(seed)
    want = np.asarray(j_ward(jnp.asarray(x), jnp.asarray(mask), factor))
    got = ward_cluster_batch(torch.from_numpy(x), torch.from_numpy(mask),
                             factor).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor", [2, 3])
def test_ward_pooling_matches_reference(factor):
    x, mask = _inputs(7, B=5, N=48, d=32)
    jp, jm = j_pool(jnp.asarray(x), jnp.asarray(mask), factor, "ward",
                    ward_kernel="ref")
    tp, tm = pool_doc_embeddings(torch.from_numpy(x), torch.from_numpy(mask),
                                 factor, "ward")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    flat, counts = compact_pooled_flat(tp, tm)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jm).sum(1))
    np.testing.assert_allclose(flat.numpy(), np.asarray(jp)[np.asarray(jm)],
                               atol=1e-5)
    n_valid = mask.sum(1)
    assert (counts.numpy() == n_valid // factor + 1).all()


@pytest.mark.parametrize("case", ["all_masked", "single_token",
                                  "n_valid_le_factor"])
def test_ward_edge_documents(case):
    rng = np.random.default_rng(3)
    N, d, factor = 12, 8, 3
    x = rng.normal(size=(2, N, d)).astype(np.float32)
    mask = np.zeros((2, N), bool)
    mask[1, :7] = True                       # a normal doc beside the edge
    if case == "single_token":
        mask[0, 4] = True
    elif case == "n_valid_le_factor":
        mask[0, :factor] = True
    want = np.asarray(j_ward(jnp.asarray(x), jnp.asarray(mask), factor))
    got = ward_cluster_batch(torch.from_numpy(x), torch.from_numpy(mask),
                             factor).numpy()
    np.testing.assert_array_equal(got, want)
    pooled, pm = pool_doc_embeddings(torch.from_numpy(x),
                                     torch.from_numpy(mask), factor, "ward")
    n0 = int(mask[0].sum())
    assert int(pm[0].sum()) == (min(n0, n0 // factor + 1) if n0 else 0)
    assert not pooled[0][~pm[0]].any()


def test_ward_wrapper_runs_plain_version_on_cpu():
    x, mask = _inputs(5)
    before = launch_counts()["ward_pool"]
    got = ward_assign(torch.from_numpy(x), torch.from_numpy(mask), 2)
    ref = ward_assign(torch.from_numpy(x), torch.from_numpy(mask), 2,
                      impl="ref")
    assert torch.equal(got, ref)
    assert launch_counts()["ward_pool"] == before
    with pytest.raises(ValueError):
        ward_assign(torch.from_numpy(x), torch.from_numpy(mask), 2,
                    impl="kernel")


@pytest.mark.parametrize("factor", [2, 4])
def test_ward_agree_is_tie_aware(factor):
    """``ward_agree`` on duplicate tokens: leaving one group or another one
    token short is a tie; moving a token between distinct groups is not,
    even at the same number of clusters."""
    n, d = 6, 16
    base = np.random.default_rng(11).normal(size=(n, d)).astype(np.float32)
    x = torch.from_numpy(np.repeat(base, factor, axis=0)[None])
    mask = torch.ones((1, n * factor), dtype=torch.bool)
    full = torch.arange(n * factor) // factor * factor   # groups merged
    a, b, c = full.clone(), full.clone(), full.clone()
    a[factor - 1] = factor - 1              # group 0 one token short
    b[2 * factor - 1] = 2 * factor - 1      # group 1 one token short
    c[factor - 1], c[2 * factor - 1] = factor - 1, 2 * factor - 1
    c[c == 2 * factor] = factor             # groups 1 and 2 joined
    a, b, c = (t[None].int() for t in (a, b, c))
    assert float(ward_objective(x, mask, a)) < 1e-10
    assert float(ward_objective(x, mask, c)) > 0.1
    assert ward_agree(x, mask, a, a).all()
    assert ward_agree(x, mask, a, b).all()
    assert not ward_agree(x, mask, a, c).any()
    assert not ward_agree(x, mask, a, full[None].int()).any()   # one fewer


def test_unpooled_and_unported_methods():
    x, mask = _inputs(9, B=2, N=10, d=8)
    jp, jm = j_pool(jnp.asarray(x), jnp.asarray(mask), 1, "ward")
    tp, tm = pool_doc_embeddings(torch.from_numpy(x), torch.from_numpy(mask),
                                 1, "ward")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    # k-means, once unported here, now pools as the reference does
    # (full parity in test_torch_kmeans.py); an unknown method raises
    jp, jm = j_pool(jnp.asarray(x), jnp.asarray(mask), 2, "kmeans")
    tp, tm = pool_doc_embeddings(torch.from_numpy(x), torch.from_numpy(mask),
                                 2, "kmeans")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    with pytest.raises(ValueError):
        pool_doc_embeddings(torch.from_numpy(x), torch.from_numpy(mask), 2,
                            "average")
