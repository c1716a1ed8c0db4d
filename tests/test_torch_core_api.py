"""The small public functions the port shares with the JAX package,
each one case of a parametrised parity test on the same numpy inputs:

* ``configs.get_ja_config``: every field the port's config has equal;
* ``core.quantization.reconstruction_error`` (rtol 1e-5: f32 sums in
  another order) and ``storage_bytes`` (equal);
* ``core.ivf.assign_vectors``: equal ids;
* ``core.maxsim.topk_docs`` on scores full of ties: equal scores and
  ids (ties to the lowest id in both);
* ``core.plaid.plaid_search_batch`` and ``plaid_search`` on a port
  ``PLAIDIndex`` holding the reference index's arrays: ids equal
  tie-aware, scores rtol 1e-5 / atol 1e-4 (as
  ``tests/test_torch_plaid_host.py``);
* ``repro_torch.core``'s exports: the names of ``repro.core.__all__``,
  ``METHODS`` equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import ivf as jivf
from repro.core import maxsim as jmaxsim
from repro.core import plaid as jplaid
from repro.core import quantization as jq
from repro.core.index import MultiVectorIndex as JIndex
from repro_torch.core import ivf as tivf
from repro_torch.core import maxsim as tmaxsim
from repro_torch.core import plaid as tplaid
from repro_torch.core import quantization as tq
from repro_torch.core.ivf import InvertedLists
from repro_torch.core.maxsim import tie_aware_mismatches

DIM = 16
RTOL, ATOL = 1e-5, 1e-4


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_config(t, j):
    jf = _fields(j)
    for name, v in _fields(t).items():
        if dataclasses.is_dataclass(v):
            _same_config(v, jf[name])
        else:
            assert v == jf[name], name


def _codecs(rng):
    cen = _unit(rng, (8, DIM))
    vec = _unit(rng, (300, DIM))
    jc = jq.train_codec(vec, cen, bits=2)
    tc = tq.ResidualCodec(*(torch.tensor(np.asarray(a)) for a in (
        jc.centroids, jc.cutoffs, jc.values)), jc.bits)
    return jc, tc, _unit(rng, (120, DIM))


def _plaid_pair(rng, n=160):
    jidx = JIndex(dim=DIM, backend="plaid", doc_maxlen=24, n_centroids=32,
                  nprobe=2, ndocs=16)
    jidx.add([_unit(rng, (int(rng.integers(2, 6)), DIM)) for _ in range(n)])
    p = jidx._plaid
    tp = tplaid.PLAIDIndex(
        codec=tq.ResidualCodec(*(torch.tensor(np.asarray(a)) for a in (
            p.codec.centroids, p.codec.cutoffs, p.codec.values)),
            p.codec.bits),
        ivf=InvertedLists(p.ivf.offsets.copy(), p.ivf.ids.copy()),
        assignments=torch.tensor(np.asarray(p.assignments, np.int32)),
        codes=torch.tensor(np.asarray(p.codes).view(np.int32)),
        vec2doc=p.vec2doc.copy(), doc_offsets=p.doc_offsets.copy(),
        doc_maxlen=p.doc_maxlen)
    return p, tp


def _search_agree(jS, jI, tS, tI):
    jS, jI = np.asarray(jS), np.asarray(jI)
    assert tie_aware_mismatches(jI, jS, tI, tS, ATOL) == 0
    np.testing.assert_allclose(tS, jS, rtol=RTOL, atol=ATOL)


def case_get_ja_config(rng):
    from repro.configs import get_ja_config as j_ja
    from repro_torch.configs import get_ja_config
    _same_config(get_ja_config(), j_ja())
    assert get_ja_config().name == "jacolbertv2"


def case_reconstruction_error(rng):
    jc, tc, v = _codecs(rng)
    want = float(jq.reconstruction_error(jc, jnp.asarray(v)))
    got = float(tq.reconstruction_error(tc, torch.from_numpy(v)))
    assert 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def case_storage_bytes(rng):
    for n, dim, bits in ((0, 128, 2), (1000, 128, 2), (77, 96, 4),
                         (5, 768, 1)):
        assert tq.storage_bytes(n, dim, bits) == jq.storage_bytes(
            n, dim, bits)


def case_assign_vectors(rng):
    v = rng.normal(size=(500, DIM)).astype(np.float32)
    c = _unit(rng, (32, DIM))
    want = jivf.assign_vectors(v, c)
    got = tivf.assign_vectors(torch.from_numpy(v), torch.from_numpy(c))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def case_topk_docs(rng):
    s = np.round(rng.normal(size=(6, 40)), 1).astype(np.float32)  # ties
    jS, jI = jmaxsim.topk_docs(jnp.asarray(s), 9)
    tS, tI = tmaxsim.topk_docs(torch.from_numpy(s), 9)
    np.testing.assert_array_equal(tS.numpy(), np.asarray(jS))
    np.testing.assert_array_equal(tI.numpy(), np.asarray(jI))


def case_plaid_search_batch(rng):
    p, tp = _plaid_pair(rng)
    qs = _unit(rng, (5, 7, DIM))
    for ndocs in (16, 8192):                  # pruned and not
        jS, jI = jplaid.plaid_search_batch(p, qs, k=6, nprobe=2,
                                           ndocs=ndocs)
        tS, tI = tplaid.plaid_search_batch(tp, torch.from_numpy(qs), k=6,
                                           nprobe=2, ndocs=ndocs)
        assert tS.shape == (5, 6) and tI.dtype == np.int64
        _search_agree(jS, jI, tS, tI)


def case_plaid_search(rng):
    p, tp = _plaid_pair(rng)
    q = _unit(rng, (7, DIM))
    jS, jI = jplaid.plaid_search(p, q, k=6, nprobe=2, ndocs=16)
    tS, tI = tplaid.plaid_search(tp, torch.from_numpy(q), k=6, nprobe=2,
                                 ndocs=16)
    assert len(tI) == len(jI) > 0
    _search_agree(jS[None], jI[None], tS[None], tI[None])


def case_core_exports(rng):
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    assert tuple(tcore.METHODS) == tuple(jcore.METHODS)


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference(case):
    CASES[case](np.random.default_rng(sorted(CASES).index(case)))
