"""The port's host probe path, dense fallback, reconstruction rerank and
flat backend against the JAX reference.

Slates and searches run on a port index holding the reference index's
own arrays (and deleted docs), so host-path candidate ids, validity and
slot order must be equal, pruned and unpruned, with and without masked
query tokens; the host and device paths give the same slate sets. The
prune's approximate scores go through the port's ``plaid_probe``
wrapper, which is held to the reference's ``_approx_scores_batch``
here. Scores: rtol 1e-5, atol 1e-4 (f32 dot products and sums in
another order; the reconstruction store is decoded in torch, equal to
the JAX decode to 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plaid as jplaid
from repro.core.index import MultiVectorIndex as JIndex
from repro_torch.core import plaid as tplaid
from repro_torch.core import quantization as tq
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.ivf import InvertedLists
from repro_torch.core.maxsim import tie_aware_mismatches
from repro_torch.kernels.plaid_probe.ref import plaid_probe_ref

DIM = 16
RTOL, ATOL = 1e-5, 1e-4
DEAD = [5, 9, 31]


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pair(seed, n=200, dead=(), **kw):
    """A reference index and a port index holding the same arrays."""
    rng = np.random.default_rng(seed)
    kw = dict(dict(doc_maxlen=24, n_centroids=32, nprobe=2, ndocs=16), **kw)
    jidx = JIndex(dim=DIM, backend="plaid", **kw)
    jidx.add([_unit(rng, (int(rng.integers(2, 6)), DIM)) for _ in range(n)])
    jidx.delete(list(dead))
    p = jidx._plaid
    tidx = MultiVectorIndex(dim=DIM, device="cpu", **kw)
    tidx._plaid = tplaid.PLAIDIndex(
        codec=tq.ResidualCodec(*(torch.tensor(np.asarray(a)) for a in (
            p.codec.centroids, p.codec.cutoffs, p.codec.values)),
            p.codec.bits),
        ivf=InvertedLists(p.ivf.offsets.copy(), p.ivf.ids.copy()),
        assignments=torch.tensor(np.asarray(p.assignments, np.int32)),
        codes=torch.tensor(np.asarray(p.codes).view(np.int32)),
        vec2doc=p.vec2doc.copy(), doc_offsets=p.doc_offsets.copy(),
        doc_maxlen=p.doc_maxlen)
    tidx.deleted = set(jidx.deleted)
    return jidx, tidx, rng


def _mask(masked, nq, lq):
    if not masked:
        return None
    m = np.ones((nq, lq), bool)
    m[0, 1] = m[2, :] = False
    return m


def _search_equal(jidx, tidx, qs, k=7, q_mask=None):
    jS, jI = jidx.search_batch(qs, k=k, q_mask=q_mask)
    tS, tI = tidx.search_batch(torch.from_numpy(qs), k=k, q_mask=(
        None if q_mask is None else torch.from_numpy(q_mask)))
    jS, jI = np.asarray(jS), np.asarray(jI)
    assert tie_aware_mismatches(jI, jS, tI, tS, ATOL) == 0
    np.testing.assert_allclose(tS, jS, rtol=RTOL, atol=ATOL)
    return tS, tI


@pytest.mark.parametrize("masked", [False, True])
def test_probe_plain_version_equals_reference_approx_scores(masked):
    """The host prune calls ``plaid_probe`` where the reference calls
    ``_approx_scores_batch`` on its masked centroid scores."""
    rng = np.random.default_rng(4)
    Nq, Lq, K, C, L = 3, 5, 12, 32, 6
    q, cen = _unit(rng, (Nq, Lq, DIM)), _unit(rng, (K, DIM))
    qm = _mask(masked, Nq, Lq)
    qm_all = np.ones((Nq, Lq), bool) if qm is None else qm
    codes = rng.integers(0, K, size=(Nq, C, L)).astype(np.int32)
    cmask = rng.random((Nq, C, L)) > 0.3
    vmask = rng.random((Nq, C)) > 0.2
    cs = jplaid._centroid_scores_batch(jnp.asarray(q), jnp.asarray(cen))
    cs = jnp.where(jnp.asarray(qm_all)[:, :, None], cs, -jnp.inf)
    want = np.asarray(jplaid._approx_scores_batch(
        cs, jnp.asarray(codes), jnp.asarray(cmask & vmask[:, :, None]),
        jnp.asarray(vmask), 0.3))
    got = plaid_probe_ref(torch.from_numpy(q), torch.from_numpy(qm_all),
                          torch.from_numpy(cen), torch.from_numpy(codes),
                          torch.from_numpy(cmask & vmask[:, :, None]),
                          torch.from_numpy(vmask), t_cs=0.3).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("branch,kw", [
    ("pruned", dict(ndocs=16)),
    ("unpruned", dict(ndocs=64, n_centroids=64, nprobe=1)),
])
@pytest.mark.parametrize("masked", [False, True])
def test_host_slates_equal_reference(branch, kw, masked):
    jidx, tidx, rng = _pair(11, dead=DEAD, **kw)
    qs = _unit(rng, (6, 3, DIM))
    q_mask = _mask(masked, 6, 3)
    live = jidx._live()
    jc, jm = jplaid.plaid_candidates(jidx._plaid, qs, nprobe=jidx.nprobe,
                                     t_cs=jidx.t_cs, ndocs=jidx.ndocs,
                                     live=live, q_mask=q_mask,
                                     probe_kernel="host")
    tidx.probe_kernel = "host"
    tc, tm = tidx.candidates(torch.from_numpy(qs), None if q_mask is None
                             else torch.from_numpy(q_mask))
    assert tc.shape == jc.shape
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(np.where(tm.numpy(), tc.numpy(), -1),
                                  np.where(jm, jc, -1))
    assert not np.isin(tc.numpy()[tm.numpy()], DEAD).any()
    counts = tm.numpy().sum(1)
    if branch == "pruned":
        assert counts.max() == tidx.ndocs
    else:
        assert tc.shape[1] <= tidx.ndocs
    if masked:
        assert counts[2] == 0


@pytest.mark.parametrize("kw", [dict(ndocs=16),
                                dict(ndocs=64, n_centroids=64, nprobe=1)])
def test_host_and_device_paths_give_the_same_slates(kw):
    _, tidx, rng = _pair(12, dead=DEAD, **kw)
    qs = torch.from_numpy(_unit(rng, (6, 3, DIM)))
    assert tidx._probe_plan(3)[0]
    slates = {}
    for probe in ("device", "host"):
        tidx.probe_kernel = probe
        c, m = tidx.candidates(qs)
        slates[probe] = [set(c[i][m[i]].tolist()) for i in range(len(c))]
    assert slates["device"] == slates["host"]
    S0, I0 = tidx.search_batch(qs, k=7)
    tidx.probe_kernel = "device"
    S1, I1 = tidx.search_batch(qs, k=7)
    assert tie_aware_mismatches(I0, S0, I1, S1, ATOL) == 0


def test_gather_cap_sends_auto_to_the_host_path(monkeypatch):
    """Above the doc_member cap (at K = 256: 65,536 docs) ``auto`` takes
    the host path and ``device`` forces the device path."""
    jidx, tidx, rng = _pair(13, **dict(ndocs=16))
    qs = _unit(rng, (5, 3, DIM))
    assert tidx._probe_plan(3)[0]
    monkeypatch.setattr(tplaid, "_DEVICE_GATHER_CAP",
                        tidx._plaid.device_ivf().doc_member.numel() - 1)
    assert not tidx._probe_plan(3)[0]
    jidx.probe_kernel = "host"
    _search_equal(jidx, tidx, qs)
    tidx.probe_kernel = "device"
    assert tidx._probe_plan(3)[0]
    _search_equal(jidx, tidx, qs)
    with pytest.raises(ValueError):
        tplaid.device_probe_plan(tidx._plaid, 3, 2, 16, "sometimes")


@pytest.mark.parametrize("masked", [False, True])
def test_host_path_search_equals_reference(masked):
    jidx, tidx, rng = _pair(14, dead=DEAD)
    jidx.probe_kernel = tidx.probe_kernel = "host"
    qs = _unit(rng, (6, 3, DIM))
    _, tI = _search_equal(jidx, tidx, qs, q_mask=_mask(masked, 6, 3))
    assert not np.isin(tI, DEAD).any()


@pytest.mark.parametrize("masked", [False, True])
def test_dense_fallback_equals_reference(masked):
    """30 docs: every slate is at least 32 wide, so the rerank is the
    all-pairs scan over the reconstruction store with a membership mask
    (ids are column indices)."""
    jidx, tidx, rng = _pair(15, n=30, dead=[2, 7], ndocs=8192)
    qs = _unit(rng, (6, 3, DIM))
    q_mask = _mask(masked, 6, 3)
    scores, cand = tidx.scored_candidates(torch.from_numpy(qs), None if
                                          q_mask is None else
                                          torch.from_numpy(q_mask))
    assert cand is None and scores.shape == (6, 30)
    assert torch.isinf(scores[:, [2, 7]]).all()
    _, tI = _search_equal(jidx, tidx, qs, q_mask=q_mask)
    assert not np.isin(tI, [2, 7]).any()


def test_recon_store_equals_reference():
    jidx, tidx, _ = _pair(16)
    jst, tst = jidx._plaid.recon_store(), tidx._plaid.recon_store()
    assert tidx._plaid.recon_store() is tst                   # cached
    jd, jm = jst.padded()
    td, tm = tst.padded()
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(tst.offsets, jst.offsets)
    assert tidx.device_bytes() > 0


@pytest.mark.parametrize("probe", ["auto", "host"])
def test_recon_rerank_equals_reference_and_packed(probe):
    jidx, tidx, rng = _pair(17, dead=DEAD)
    qs = _unit(rng, (6, 4, DIM))
    pS, pI = tidx.search_batch(torch.from_numpy(qs), k=7)
    for idx in (jidx, tidx):
        idx.packed_rerank = False
        idx.probe_kernel = probe
    assert tidx._plaid.recon is None
    rS, rI = _search_equal(jidx, tidx, qs)
    assert tidx._plaid.recon is not None
    assert tie_aware_mismatches(pI, pS, rI, rS, ATOL) == 0
    np.testing.assert_allclose(rS, pS, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_flat_index_equals_reference(masked):
    rng = np.random.default_rng(18)
    docs = [_unit(rng, (int(rng.integers(1, 9)), DIM)) for _ in range(70)]
    jidx = JIndex(dim=DIM, backend="flat", doc_maxlen=6)
    jidx.add(docs)
    tidx = MultiVectorIndex(dim=DIM, backend="flat", doc_maxlen=6,
                            device="cpu")
    tidx.add([torch.from_numpy(v) for v in docs])
    assert tidx.candidates(torch.zeros(1, 3, DIM)) == (None, None)
    assert tidx.n_vectors() == jidx.n_vectors()
    assert tidx.device_bytes() == (jidx.device_bytes()
                                   + tidx._store.flat.numel() * 4)
    qs = _unit(rng, (6, 3, DIM))
    S, I = _search_equal(jidx, tidx, qs, k=10, q_mask=_mask(masked, 6, 3))
    assert (I >= 0).all() and S.shape == (6, 10)
