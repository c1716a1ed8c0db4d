"""The plain version of the port's ``plaid_probe`` kernel against the
JAX reference ``repro.kernels.plaid_probe.ref.plaid_probe_ref`` (whose
candidate axis is a multiple of its 32-wide scan block).

-inf slots (invalid candidates) must be equal; finite scores agree to
1e-5 (the centroid products and the query-token sums run in another
order). Masked query tokens are covered: they contribute 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.plaid_probe.ref import plaid_probe_ref as j_probe
from repro_torch.kernels import launch_counts
from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores
from repro_torch.kernels.plaid_probe.ref import (fold_codes_ref,
                                                 plaid_probe_folded_ref,
                                                 probe_table_ref)


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed, Nq=3, Lq=6, dim=16, K=24, C=64, L=9):
    rng = np.random.default_rng(seed)
    q = _unit(rng, (Nq, Lq, dim))
    qm = rng.random((Nq, Lq)) < 0.7
    qm[0] = False                           # a query with no valid token
    cen = _unit(rng, (K, dim))
    codes = rng.integers(0, K, size=(Nq, C, L)).astype(np.int32)
    cmask = rng.random((Nq, C, L)) < 0.6
    vmask = rng.random((Nq, C)) < 0.8
    return q, qm, cen, codes, cmask, vmask


def _both(args, t_cs, impl="auto"):
    want = np.asarray(j_probe(*(jnp.asarray(a) for a in args), t_cs=t_cs))
    got = plaid_probe_scores(*(torch.from_numpy(a) for a in args),
                             t_cs=t_cs, impl=impl).numpy()
    return got, want


@pytest.mark.parametrize("t_cs", [0.0, 0.3, -0.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_probe_plain_matches_reference(seed, t_cs):
    got, want = _both(_inputs(seed), t_cs)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    assert (got[0][fin[0]] == 0).all()      # fully masked query scores 0


def test_probe_cpu_dispatch_is_the_plain_version():
    args = _inputs(2)
    before = launch_counts()["plaid_probe"]
    auto, _ = _both(args, 0.3)
    ref, _ = _both(args, 0.3, impl="ref")
    np.testing.assert_array_equal(auto, ref)
    assert launch_counts()["plaid_probe"] == before


def test_probe_all_invalid_and_single_token():
    q, qm, cen, codes, cmask, vmask = _inputs(3, C=32, L=1)
    vmask[:] = False
    got, want = _both((q, qm, cen, codes, cmask, vmask), 0.3)
    assert np.isneginf(got).all() and np.isneginf(want).all()


@pytest.mark.parametrize("t_cs", [0.0, 0.3, -0.2])
@pytest.mark.parametrize("seed", [0, 4])
def test_probe_folded_formulation_matches_reference(seed, t_cs):
    """The kernel's formulation (a table with a zero row for masked tokens
    and a -inf row, tokens folded to rows; with distinct-code lookups,
    repeated rows dropped) against the JAX reference: -inf slots equal,
    finite scores to 1e-5 (products and sums in another order); the
    distinct-code lookups equal the full ones bit for bit."""
    args = _inputs(seed, L=40)
    args[3][:, ::2] = args[3][:, ::2, :1]    # crowded docs: one code repeated
    want = np.asarray(j_probe(*(jnp.asarray(a) for a in args), t_cs=t_cs))
    t = [torch.from_numpy(a) for a in args]
    full = plaid_probe_folded_ref(*t, t_cs=t_cs).numpy()
    dedup = plaid_probe_folded_ref(*t, t_cs=t_cs, distinct=True).numpy()
    np.testing.assert_array_equal(dedup, full)
    np.testing.assert_array_equal(np.isinf(full), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(full[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_probe_table_rows_and_fold():
    """Row K of the table is 0 and row K + 1 is -inf for every query
    token; masked tokens fold to row K; a repeated row is dropped to
    K + 1 after its first place."""
    q, qm, cen, codes, cmask, vmask = _inputs(5)
    K = cen.shape[0]
    table = probe_table_ref(torch.from_numpy(q), torch.from_numpy(qm),
                            torch.from_numpy(cen), t_cs=0.3).numpy()
    assert table.shape == (q.shape[0], K + 2, q.shape[1])
    assert (table[:, K] == 0).all() and np.isneginf(table[:, K + 1]).all()
    off = fold_codes_ref(torch.tensor([[3, 5, 3, 3, 5]]),
                         torch.tensor([[True, True, False, True, True]]), K)
    np.testing.assert_array_equal(off.numpy(), [[3, 5, K, 3, 5]])
    dd = fold_codes_ref(torch.tensor([[3, 5, 3, 3, 5]]),
                        torch.tensor([[True, True, False, True, True]]), K,
                        distinct=True)
    np.testing.assert_array_equal(dd.numpy(), [[3, 5, K, K + 1, K + 1]])
