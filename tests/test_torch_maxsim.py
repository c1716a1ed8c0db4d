"""The port's MaxSim plain versions and scoring entry points against the
JAX package.

``kernels/maxsim/ref.py`` (what CPU tensors run, and what the card
kernels are held to) against ``repro.kernels.maxsim.ops.maxsim`` /
``maxsim_rerank`` — the Pallas kernels, in interpret mode on the CPU —
and against the JAX refs; ``core/maxsim.py``'s ``maxsim_all_docs``
and the slabbed ``maxsim_rerank_store`` against the JAX entry points;
``DocStore``'s padded view against the JAX store's; the in-place
rerank's plain version (``maxsim_rerank_indexed``) against the JAX
store's gather-then-rerank, with invalid candidates holding ids outside
the store. Inputs include
masked query tokens, a query with no valid token, a doc with no valid
token, and Nd across the plain version's doc block (256) and the JAX
CPU path's (2048).

Tolerance: rtol 1e-5, atol 1e-4 — f32 dot products and sums in another
order, also for the all-pairs and rerank kernels' 3xTF32 products
(``maxsim_3xtf32_ref``, ``maxsim_rerank_3xtf32_ref``); the padded views
are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import maxsim as jms
from repro.core.docstore import DocStore as JDocStore
from repro.kernels.maxsim import ops as jops
from repro.kernels.maxsim.ref import maxsim_ref as j_ref
from repro.kernels.maxsim.ref import maxsim_rerank_ref as j_rerank_ref
from repro_torch.core import maxsim as tms
from repro_torch.core.docstore import DocStore
from repro_torch.kernels import launch_counts
from repro_torch.kernels.maxsim import ops
from repro_torch.kernels.maxsim.ref import (maxsim_3xtf32_ref,
                                           maxsim_rerank_3xtf32_ref)

RTOL, ATOL = 1e-5, 1e-4


def _inputs(seed, nq, lq, nd, ld, dim, per_query=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, lq, dim)).astype(np.float32)
    dshape = (nq, nd, ld, dim) if per_query else (nd, ld, dim)
    d = rng.normal(size=dshape).astype(np.float32)
    qm = rng.random((nq, lq)) > 0.2
    qm[-1] = False                                  # no valid query token
    dm = rng.random(dshape[:-1]) > 0.3
    dm[..., 0, :] = False                           # a doc with no token
    return q, qm, d, dm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("nq,lq,nd,ld,dim", [
    (3, 8, 9, 12, 16),
    (2, 5, 300, 7, 8),          # across the plain version's doc block
    (4, 32, 17, 40, 32),
])
def test_maxsim_plain_equals_jax_kernel_and_ref(nq, lq, nd, ld, dim):
    q, qm, d, dm = _inputs(nd, nq, lq, nd, ld, dim)
    before = launch_counts()
    got = ops.maxsim(*_t(q, qm, d, dm)).numpy()
    assert launch_counts() == before              # CPU: no kernel launch
    kern = np.asarray(jops.maxsim(jnp.asarray(q), jnp.asarray(qm),
                                  jnp.asarray(d), jnp.asarray(dm),
                                  block_q=4, block_d=8))
    ref = np.asarray(j_ref(q, qm, d, dm))
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert (got[:, 0] == 0).all() and (got[-1] == 0).all()


@pytest.mark.parametrize("nq,lq,s,ld,dim", [
    (3, 8, 9, 12, 16), (1, 4, 1, 5, 8), (2, 16, 21, 30, 32),
])
def test_maxsim_rerank_plain_equals_jax_kernel_and_ref(nq, lq, s, ld, dim):
    q, qm, d, dm = _inputs(s, nq, lq, s, ld, dim, per_query=True)
    got = ops.maxsim_rerank(*_t(q, qm, d, dm)).numpy()
    kern = np.asarray(jops.maxsim_rerank(jnp.asarray(q), jnp.asarray(qm),
                                         jnp.asarray(d), jnp.asarray(dm),
                                         block_s=4))
    ref = np.asarray(j_rerank_ref(q, qm, d, dm))
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("nd", [40, 2100])    # one JAX block, and two
def test_maxsim_all_docs_equals_jax(nd):
    q, qm, d, dm = _inputs(7, 3, 6, nd, 5, 8)
    got = tms.maxsim_all_docs(*_t(q, qm, d, dm)).numpy()
    want = np.asarray(jms.maxsim_all_docs(jnp.asarray(q), jnp.asarray(qm),
                                          jnp.asarray(d), jnp.asarray(dm)))
    assert got.shape == want.shape == (3, nd)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _stores(seed, n=50, dim=16, doc_maxlen=6):
    rng = np.random.default_rng(seed)
    docs = [rng.normal(size=(int(rng.integers(1, 9)), dim)).astype(np.float32)
            for _ in range(n)]
    docs[4] = np.zeros((0, dim), np.float32)          # an empty doc
    jst = JDocStore(dim, doc_maxlen)
    jst.add(docs)
    tst = DocStore(dim, doc_maxlen, "cpu")
    tst.add([torch.from_numpy(v) for v in docs])
    return jst, tst, rng


def test_docstore_padded_view_equals_jax():
    jst, tst, _ = _stores(1)
    for j, t in zip(jst.padded(), tst.padded()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tst.n_docs == jst.n_docs
    assert tst.n_vectors() == jst.n_vectors()
    assert tst.nbytes() == jst.nbytes()
    np.testing.assert_array_equal(tst.doc_lengths(), jst.doc_lengths())
    # the port's device bytes add the flat rows to the padded view's
    assert tst.device_nbytes() == jst.device_nbytes() + tst.flat.numel() * 4
    cand = np.array([[0, 4, 7], [49, 3, 3]])
    for j, t in zip(jst.gather(cand), tst.gather(torch.from_numpy(cand))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_docstore_from_arrays_keeps_live_and_offsets():
    jst, tst, _ = _stores(2)
    live = np.ones(tst.n_docs, bool)
    live[[1, 5]] = False
    st = DocStore.from_arrays(tst.flat, tst.offsets, live, doc_maxlen=6)
    assert st.n_vectors() == tst.n_vectors() - int(
        tst.doc_lengths()[[1, 5]].sum())
    np.testing.assert_array_equal(st.padded()[0].numpy(),
                                  tst.padded()[0].numpy())


def test_maxsim_rerank_store_equals_jax():
    """Slabbed at 8 over 21 candidate slots: three slabs, the last
    ragged; invalid slots come back -inf."""
    jst, tst, rng = _stores(3)
    q = rng.normal(size=(4, 5, 16)).astype(np.float32)
    qm = rng.random((4, 5)) > 0.2
    cand = rng.integers(0, 50, size=(4, 21))
    cmask = rng.random((4, 21)) > 0.25
    got = tms.maxsim_rerank_store(tst, *_t(q, qm, cand, cmask),
                                  slab=8).numpy()
    want = np.asarray(jms.maxsim_rerank_store(
        jst, jnp.asarray(q), jnp.asarray(qm), cand, cmask, slab=8))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[~cmask]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_wrappers_check_impl():
    q, qm, d, dm = _t(*_inputs(0, 2, 3, 4, 5, 8))
    with pytest.raises(ValueError):
        ops.maxsim(q, qm, d, dm, impl="kernel")
    np.testing.assert_array_equal(ops.maxsim(q, qm, d, dm, impl="ref"),
                                  ops.maxsim(q, qm, d, dm))


@pytest.mark.parametrize("nq,lq,nd,ld,dim", [
    (3, 32, 20, 129, 128),      # the flat path's widths
    (4, 40, 9, 30, 128),
    (2, 16, 33, 12, 64),
])
def test_maxsim_3xtf32_matches_jax(nq, lq, nd, ld, dim):
    """The all-pairs kernel's products (``maxsim_3xtf32_ref``: hi.hi +
    hi.lo + lo.hi of TF32 parts) against the Pallas kernel (interpret
    mode) and the JAX reference to rtol 1e-5, atol 1e-4; one TF32 pass
    (``passes=1``) misses that tolerance."""
    q, qm, d, dm = _inputs(lq + nd, nq, lq, nd, ld, dim)
    kern = np.asarray(jops.maxsim(jnp.asarray(q), jnp.asarray(qm),
                                  jnp.asarray(d), jnp.asarray(dm),
                                  block_q=4, block_d=8))
    ref = np.asarray(j_ref(q, qm, d, dm))
    args = _t(q, qm, d, dm)
    got = maxsim_3xtf32_ref(*args).numpy()
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert (got[:, 0] == 0).all() and (got[-1] == 0).all()
    one = maxsim_3xtf32_ref(*args, passes=1).numpy()
    assert not np.allclose(one, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lq", [32, 100, 150])  # 150: past a launch's 128
def test_maxsim_rerank_3xtf32_matches_jax(lq):
    """The rerank kernel's products (``maxsim_rerank_3xtf32_ref``) against
    the Pallas kernel (interpret mode) and the JAX reference to rtol 1e-5,
    atol 1e-4, at S = 13 candidates (not a multiple of 8), a fully masked
    candidate and a query with no valid token; one TF32 pass misses that
    tolerance."""
    q, qm, d, dm = _inputs(lq, 3, lq, 13, 20, 128, per_query=True)
    kern = np.asarray(jops.maxsim_rerank(jnp.asarray(q), jnp.asarray(qm),
                                         jnp.asarray(d), jnp.asarray(dm),
                                         block_s=4))
    ref = np.asarray(j_rerank_ref(q, qm, d, dm))
    args = _t(q, qm, d, dm)
    got = maxsim_rerank_3xtf32_ref(*args).numpy()
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert (got[:, 0] == 0).all() and (got[-1] == 0).all()
    one = maxsim_rerank_3xtf32_ref(*args, passes=1).numpy()
    assert not np.allclose(one, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_maxsim_rerank_indexed_plain_equals_jax_store(seed):
    """``maxsim_rerank_indexed`` on the store's padded view (CPU: its
    plain version) against the JAX ``maxsim_rerank_store``, which gathers
    the candidates first: equal to rtol 1e-5 / atol 1e-4 on valid slots,
    0 on invalid ones, whose ids lie outside the store (the JAX side gets
    id 0 there: its gather would clamp them); the port's store rerank
    gives -inf there, as the JAX one."""
    jst, tst, rng = _stores(seed)
    q = rng.normal(size=(4, 5, 16)).astype(np.float32)
    qm = rng.random((4, 5)) > 0.2
    cand = rng.integers(0, 50, size=(4, 21))
    cmask = rng.random((4, 21)) > 0.25
    cmask[0] = False                                 # no valid candidate
    bad = np.where(cmask, cand, rng.choice([-7, 50, 10 ** 9], size=cand.shape))
    want = np.asarray(jms.maxsim_rerank_store(
        jst, jnp.asarray(q), jnp.asarray(qm), np.where(cmask, cand, 0),
        cmask))
    d, dm = tst.padded()
    before = launch_counts()
    got = ops.maxsim_rerank_indexed(*_t(q, qm), d, dm,
                                    *_t(bad, cmask)).numpy()
    assert launch_counts() == before              # CPU: no kernel launch
    np.testing.assert_allclose(got[cmask], want[cmask], rtol=RTOL, atol=ATOL)
    assert (got[~cmask] == 0).all()
    store = tms.maxsim_rerank_store(tst, *_t(q, qm, bad, cmask)).numpy()
    assert np.isinf(store[~cmask]).all()
    np.testing.assert_array_equal(store[cmask], got[cmask])
