"""Five places where the port's result or form differed from the JAX
package's, each held to the reference on the CPU.

* ``core.pooling.compact_pooled``: the reference's list of per-doc f32
  numpy arrays (``[]`` for an empty batch), bitwise equal to
  ``repro.core.pooling.compact_pooled``'s on numpy inputs and on tensors
  (those through ``compact_pooled_begin`` / ``_finish``); the port's
  tuple form is ``compact_pooled_flat``, and split by its counts it is
  the same list.
* ``PLAIDIndex.device_bytes_detail()``: the reference's four keys, equal
  key by key (a) before any search, (b) after a search, (c) after
  ``add`` and after ``delete`` before the next search, (d) with the
  reconstruction store built. ``recon`` adds one stated term: the
  store's flat rows, which live on the card in the port
  (``DocStore.device_nbytes``). ``device_bytes()`` is the sum.
* ``WARD_IMPLS`` / ``PROBE_IMPLS`` are the reference's three values;
  ``impl="kernel"`` on a CPU or ``meta`` tensor raises an error that
  names the card, and never runs the plain version.
* ``kernels.quant.ref.dequant_score_ref`` takes the reference's
  pre-gathered centroid rows and agrees with the JAX one to atol 1e-4
  (``tests/test_torch_dequant.py``'s tolerance); the gathered form is
  ``dequant_score_ids_ref``, the wrapper's plain version.
* ``DocStore()`` with no device resolves it: ``cuda``, or an error
  without a card; ``from_arrays`` keeps the tensor's device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plaid as jplaid
from repro.core import pooling as jpool
from repro.core.index import MultiVectorIndex as JIndex
from repro.core.quantization import encode as j_encode
from repro.core.quantization import train_codec as j_train_codec
from repro.kernels.plaid_probe.ops import PROBE_IMPLS as J_PROBE_IMPLS
from repro.kernels.quant.ref import dequant_score_ref as j_dequant_score_ref
from repro.kernels.ward_pool.ops import WARD_IMPLS as J_WARD_IMPLS
from repro_torch.core import plaid as tplaid
from repro_torch.core import pooling as tpool
from repro_torch.core import quantization as tq
from repro_torch.core.docstore import DocStore
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.ivf import InvertedLists
from repro_torch.core.spec import PoolingSpec
from repro_torch.kernels import launch_counts
from repro_torch.kernels.plaid_probe.ops import PROBE_IMPLS, plaid_probe_scores
from repro_torch.kernels.quant.ops import dequant_score
from repro_torch.kernels.quant.ref import (dequant_score_ids_ref,
                                           dequant_score_ref)
from repro_torch.kernels.ward_pool.ops import WARD_IMPLS, ward_assign

DIM = 16


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ------------------------------------------------------------ compaction
# (B, N, d, share of valid slots); "none" masks every slot, "empty" has
# no document
COMPACT_CASES = {"mixed": (5, 9, 8, 0.5), "dense": (3, 6, 4, 1.0),
                 "none": (4, 7, 3, 0.0), "empty": (0, 5, 4, 0.5),
                 "one_doc": (1, 12, 16, 0.3)}


def _pooled(B, N, d, share, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, d)).astype(np.float32)
    m = rng.random((B, N)) < share
    if B > 1 and 0 < share < 1:
        m[1] = False                      # an empty document
    return np.where(m[..., None], x, 0).astype(np.float32), m


def _bitwise_lists(got, want):
    assert isinstance(got, list) and len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype == np.float32
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_pooled_is_the_reference_list(case):
    x, m = _pooled(*COMPACT_CASES[case])
    want_dev = jpool.compact_pooled(jnp.asarray(x), jnp.asarray(m))
    want_host = jpool.compact_pooled(x, m)
    got_t = tpool.compact_pooled(torch.from_numpy(x), torch.from_numpy(m))
    got_n = tpool.compact_pooled(x, m)
    for got in (got_t, got_n):
        _bitwise_lists(got, want_dev)
        _bitwise_lists(got, want_host)
    if x.shape[0] == 0:
        assert got_t == [] and got_n == []


@pytest.mark.parametrize("case", ["mixed", "dense", "one_doc"])
def test_compact_pooled_flat_split_is_the_list(case):
    x, m = _pooled(*COMPACT_CASES[case], seed=1)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    flat, counts = tpool.compact_pooled_flat(xt, mt)
    split = [f.numpy() for f in torch.split(flat, counts.tolist())]
    _bitwise_lists(split, tpool.compact_pooled(xt, mt))
    fin = tpool.compact_pooled_finish(tpool.compact_pooled_begin(xt, mt))
    _bitwise_lists(fin, tpool.compact_pooled(xt, mt))


def test_compact_pooled_is_exported_from_core():
    import repro_torch.core as core
    assert core.compact_pooled is tpool.compact_pooled


# ---------------------------------------------------------- device bytes
def _pair(seed, n=60, **kw):
    """A reference plaid index and a port index holding the same arrays
    (the reference's codec, assignments and codes), neither searched."""
    rng = np.random.default_rng(seed)
    kw = dict(dict(doc_maxlen=24, n_centroids=32, nprobe=2, ndocs=16), **kw)
    jidx = JIndex(dim=DIM, backend="plaid", **kw)
    jidx.add([_unit(rng, (int(rng.integers(2, 6)), DIM)) for _ in range(n)])
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
    return jidx, tidx, rng


def _same_detail(jidx, tidx, recon_extra=0):
    want = {k: int(v) for k, v in jidx._plaid.device_bytes_detail().items()}
    got = tidx._plaid.device_bytes_detail()
    assert set(got) == {"packed", "codec", "recon", "ivf"} == set(want)
    want["recon"] += recon_extra
    assert got == want
    assert tidx._plaid.device_bytes() == sum(want.values())
    assert tidx.device_bytes() == sum(want.values())
    return got


def _search(jidx, tidx, rng):
    qs = _unit(rng, (3, 4, DIM))
    jidx.search_batch(qs, k=5)
    tidx.search_batch(torch.from_numpy(qs), k=5)


def test_device_bytes_before_any_search():
    jidx, tidx, _ = _pair(16)
    assert tidx._plaid._packed_padded is None
    got = _same_detail(jidx, tidx)
    assert got["packed"] > 0 and got["recon"] == got["ivf"] == 0
    # no view is built by reading the figure
    assert tidx._plaid._packed_padded is None
    assert tidx._plaid._device_ivf is None


def test_device_bytes_after_a_search_match_the_resident_views():
    jidx, tidx, rng = _pair(17)
    _search(jidx, tidx, rng)
    got = _same_detail(jidx, tidx)
    p = tidx._plaid
    assert p._packed_padded is not None and got["ivf"] > 0
    assert got["packed"] == sum(t.numel() * t.element_size()
                                for t in p.padded_packed())
    assert got["ivf"] == p.device_ivf().device_bytes()


@pytest.mark.parametrize("op", ["add", "delete"])
def test_device_bytes_after_mutation_before_the_next_search(op):
    jidx, tidx, rng = _pair(18)
    _search(jidx, tidx, rng)
    if op == "add":
        docs = [_unit(rng, (int(rng.integers(2, 9)), DIM)) for _ in range(7)]
        jidx._plaid.add(docs)
        tidx._plaid.add([torch.from_numpy(d) for d in docs])
    else:
        jidx._plaid.delete([0, 3, 11])
        tidx._plaid.delete([0, 3, 11])
    assert tidx._plaid._packed_padded is None       # views invalidated
    got = _same_detail(jidx, tidx)
    assert got["packed"] > 0 and got["ivf"] == 0
    # the next search, on the bare PLAID indexes (the facades' live masks
    # do not see a mutation made under them), builds the views again
    qs = _unit(rng, (3, 4, DIM))
    jplaid.plaid_search_batch(jidx._plaid, jnp.asarray(qs), k=5, nprobe=2,
                              ndocs=16)
    tplaid.plaid_search_batch(tidx._plaid, torch.from_numpy(qs), k=5,
                              nprobe=2, ndocs=16)
    assert tidx._plaid._packed_padded is not None
    _same_detail(jidx, tidx)


def test_device_bytes_with_the_reconstruction_store():
    jidx, tidx, rng = _pair(19)
    for idx in (jidx, tidx):
        idx.packed_rerank = False
    _search(jidx, tidx, rng)
    assert tidx._plaid.recon is not None
    # the port's store keeps its flat [n_vectors, dim] f32 rows on the card
    extra = tidx._plaid.recon.flat.numel() * 4
    assert extra == tidx._plaid.n_vectors * DIM * 4
    got = _same_detail(jidx, tidx, recon_extra=extra)
    assert got["recon"] > extra


def test_device_bytes_of_an_empty_store():
    _, tidx, _ = _pair(20, n=1)
    tidx._plaid.delete([0])
    detail = tidx._plaid.device_bytes_detail()
    assert detail["packed"] == 1 * 1 * (4 + 4 * tidx._plaid.codes.shape[1]
                                        + 1)


# ------------------------------------------------------- impl="kernel"
def _ward_inputs(device="cpu"):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 9, 8)).astype(np.float32))
    m = torch.from_numpy(rng.random((2, 9)) < 0.8)
    return x.to(device), m.to(device)


def _probe_inputs(device="cpu"):
    rng = np.random.default_rng(4)
    Nq, Lq, dim, K, C, L = 2, 3, 8, 5, 4, 6
    args = (rng.normal(size=(Nq, Lq, dim)).astype(np.float32),
            rng.random((Nq, Lq)) < 0.9,
            rng.normal(size=(K, dim)).astype(np.float32),
            rng.integers(0, K, size=(Nq, C, L)).astype(np.int32),
            rng.random((Nq, C, L)) < 0.7, rng.random((Nq, C)) < 0.8)
    return tuple(torch.from_numpy(a).to(device) for a in args)


def test_impls_are_the_reference_values():
    assert WARD_IMPLS == tuple(J_WARD_IMPLS) == ("auto", "kernel", "ref")
    assert PROBE_IMPLS == tuple(J_PROBE_IMPLS) == ("auto", "kernel", "ref")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_forced_kernel_raises_off_the_card(device):
    before = dict(launch_counts())
    with pytest.raises(ValueError, match="only on the card"):
        ward_assign(*_ward_inputs(device), 2, impl="kernel")
    with pytest.raises(ValueError, match="only on the card"):
        plaid_probe_scores(*_probe_inputs(device), t_cs=0.3, impl="kernel")
    assert launch_counts() == before


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ward_and_probe_plain_routes_unchanged(impl):
    """``"auto"`` and ``"ref"`` still run the plain version on the CPU."""
    x, m = _ward_inputs()
    assert torch.equal(ward_assign(x, m, 2, impl=impl),
                       ward_assign(x, m, 2, impl="ref"))
    a = plaid_probe_scores(*_probe_inputs(), t_cs=0.3, impl=impl)
    b = plaid_probe_scores(*_probe_inputs(), t_cs=0.3, impl="ref")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ward_assign(x, m, 2, impl="plain")


def test_pooling_spec_forcing_the_kernel_raises_off_the_card():
    x, m = _ward_inputs()
    with pytest.raises(ValueError, match="only on the card"):
        PoolingSpec("ward", 2, ward_kernel="kernel").apply(x, m)
    with pytest.raises(ValueError, match="only on the card"):
        tpool.pool_doc_embeddings(x, m, 2, "ward", ward_kernel="kernel")


# ------------------------------------------------------ dequant_score_ref
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m,dim,lq", [(100, 128, 16), (300, 64, 32)])
def test_dequant_score_ref_in_the_reference_form(m, dim, lq, bits):
    rng = np.random.default_rng(m + bits)
    vecs = _unit(rng, (m, dim))
    cents = _unit(rng, (16, dim))
    codec = j_train_codec(jnp.asarray(vecs), jnp.asarray(cents), bits=bits)
    ids, words = j_encode(codec, jnp.asarray(vecs))
    q = rng.normal(size=(lq, dim)).astype(np.float32)
    rows = jnp.take(codec.centroids, ids, axis=0)
    want = np.asarray(j_dequant_score_ref(words, rows, codec.values,
                                          jnp.asarray(q), bits))
    tw = torch.from_numpy(np.asarray(words).view(np.int32).copy())
    got = dequant_score_ref(tw, torch.tensor(np.asarray(rows)),
                            torch.tensor(np.asarray(codec.values)),
                            torch.from_numpy(q), bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, lq)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the gathered form is the wrapper's plain version, bit for bit
    tid = torch.from_numpy(np.asarray(ids, np.int32).copy())
    cen = torch.tensor(np.asarray(codec.centroids))
    vals = torch.tensor(np.asarray(codec.values))
    gathered = dequant_score_ids_ref(tw, tid, cen, vals, torch.from_numpy(q),
                                     bits)
    assert torch.equal(gathered, dequant_score(tw, tid, cen, vals,
                                               torch.from_numpy(q),
                                               bits=bits))
    assert torch.equal(gathered, dequant_score_ref(tw, cen[tid.long()], vals,
                                                   torch.from_numpy(q), bits))


# ---------------------------------------------------------------- DocStore
def test_docstore_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DocStore(DIM, 8)
    store = DocStore(DIM, 8, device="cpu")
    assert store.device == torch.device("cpu")
    flat = torch.zeros((5, DIM))
    kept = DocStore.from_arrays(flat, np.array([0, 2, 5]), np.ones(2, bool))
    assert kept.device == flat.device and kept.n_docs == 2
