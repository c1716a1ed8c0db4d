"""The port's PLAID codec, candidate slates and search against the JAX
reference (``repro.core.quantization``, ``repro.core.plaid``).

Slates and searches run on a port index holding the reference index's
own arrays, so candidate ids, validity and slot order must be equal in
both the pruned and the unpruned branch, and the packed-rerank scores
agree to 1e-5 (sums in another order). ``encode`` given the reference's
codec gives equal ids and words except on rows at a near-tie of the
centroid argmax, whose count is asserted small.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import MultiVectorIndex as JIndex
from repro.core import plaid as jplaid
from repro.core import quantization as jq
from repro_torch.core import plaid as tplaid
from repro_torch.core import quantization as tq
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.ivf import InvertedLists

DIM = 16


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _docs(rng, n, lo, hi):
    return [_unit(rng, (int(rng.integers(lo, hi)), DIM)) for _ in range(n)]


def _codec(c):
    return tq.ResidualCodec(torch.tensor(np.asarray(c.centroids)),
                            torch.tensor(np.asarray(c.cutoffs)),
                            torch.tensor(np.asarray(c.values)), c.bits)


def _pair(seed, n=200, lo=2, hi=6, **kw):
    """A reference index and a port index holding the same arrays."""
    rng = np.random.default_rng(seed)
    kw = dict(dict(doc_maxlen=24, n_centroids=32, nprobe=2, ndocs=16), **kw)
    jidx = JIndex(dim=DIM, backend="plaid", **kw)
    jidx.add(_docs(rng, n, lo, hi))
    p = jidx._plaid
    tidx = MultiVectorIndex(dim=DIM, device="cpu", **kw)
    tidx._plaid = tplaid.PLAIDIndex(
        codec=_codec(p.codec),
        ivf=InvertedLists(p.ivf.offsets.copy(), p.ivf.ids.copy()),
        assignments=torch.tensor(np.asarray(p.assignments, np.int32)),
        codes=torch.tensor(np.asarray(p.codes).view(np.int32)),
        vec2doc=p.vec2doc.copy(), doc_offsets=p.doc_offsets.copy(),
        doc_maxlen=p.doc_maxlen)
    return jidx, tidx, rng


@pytest.mark.parametrize("bits", [2, 4])
def test_encode_with_reference_codec(bits):
    rng = np.random.default_rng(bits)
    x = _unit(rng, (3000, DIM))
    cen = np.asarray(jq.train_codec(jnp.asarray(x[:1000]),
                                    jnp.asarray(x[:32]), bits=bits).centroids)
    codec = jq.train_codec(jnp.asarray(x[:1000]), jnp.asarray(cen), bits=bits)
    ja, jw = jq.encode(codec, jnp.asarray(x[1000:]))
    ta, tw = tq.encode(_codec(codec), torch.from_numpy(x[1000:]))
    ja, jw = np.array(ja), np.array(jw).view(np.int32)
    differ = (ja != ta.numpy()) | (jw != tw.numpy()).any(axis=1)
    assert differ.sum() <= 2, differ.sum()      # argmax near-ties only
    same = ~differ
    np.testing.assert_array_equal(tw.numpy()[same], jw[same])
    rec_j = np.asarray(jq.decode(codec, jnp.asarray(ja), jnp.asarray(
        jw.view(np.uint32))))
    rec_t = tq.decode(_codec(codec), torch.from_numpy(ja),
                      torch.from_numpy(jw)).numpy()
    np.testing.assert_allclose(rec_t, rec_j, atol=1e-6)


@pytest.mark.parametrize("branch,kw", [
    ("pruned", dict(ndocs=16)),
    ("unpruned", dict(ndocs=64, n_centroids=64, nprobe=1)),
])
@pytest.mark.parametrize("masked", [False, True])
def test_device_slates_equal_reference(branch, kw, masked):
    jidx, tidx, rng = _pair(11, **kw)
    qs = _unit(rng, (6, 3, DIM))
    q_mask = None
    if masked:
        q_mask = np.ones((6, 3), bool)
        q_mask[0, 1] = q_mask[2, :] = False
    use, geom = jplaid.device_probe_plan(jidx._plaid, 3, jidx.nprobe,
                                         jidx.ndocs, "device")
    tuse, tgeom = tplaid.device_probe_plan(tidx._plaid, 3, tidx.nprobe,
                                           tidx.ndocs)
    assert use and tuse and geom[1:] == tgeom[1:]
    jc, jm = jplaid.plaid_candidates(jidx._plaid, qs, nprobe=jidx.nprobe,
                                     t_cs=jidx.t_cs, ndocs=jidx.ndocs,
                                     q_mask=q_mask, probe_kernel="device")
    tc, tm = tidx.candidates(torch.from_numpy(qs), None if q_mask is None
                             else torch.from_numpy(q_mask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(np.where(tm.numpy(), tc.numpy(), -1),
                                  np.where(np.asarray(jm), np.asarray(jc), -1))
    counts = tm.numpy().sum(1)
    pruned = tplaid._ladder(counts.max()) > tidx.ndocs
    if branch == "unpruned":
        assert not pruned, counts
    else:   # the prune kept the best ndocs of a wider slate
        assert counts.max() == tidx.ndocs
    if masked:
        assert counts[2] == 0


def test_packed_search_equals_reference():
    jidx, tidx, rng = _pair(12)
    qs = _unit(rng, (5, 4, DIM))
    jS, jI = jidx.search_batch(qs, k=7)
    tS, tI = tidx.search_batch(torch.from_numpy(qs), k=7)
    np.testing.assert_array_equal(tI, jI)
    np.testing.assert_allclose(tS, jS, rtol=1e-5, atol=1e-5)
    rS, rI = tidx.search_batch(torch.from_numpy(qs), k=7, impl="ref")
    np.testing.assert_array_equal(rI, tI)


def test_device_ivf_and_padded_views_equal_reference():
    jidx, tidx, _ = _pair(13)
    jd, td = jidx._plaid.device_ivf(), tidx._plaid.device_ivf()
    assert jd.list_cap == td.list_cap and jd.overflow == 0
    np.testing.assert_array_equal(td.doc_member.numpy(),
                                  np.asarray(jd.doc_member))
    np.testing.assert_array_equal(td.doc_lists.numpy(),
                                  np.asarray(jd.doc_lists))
    np.testing.assert_array_equal(td.doc_valid.numpy(),
                                  np.asarray(jd.doc_valid))
    for j, t in zip(jidx._plaid.padded_packed(), tidx._plaid.padded_packed()):
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(j).view(t.numpy().dtype))
