"""The replicated index's SPMD flat plan (``repro_torch.core.replicated``
``_FlatPlan`` and ``ReplicatedIndex._plan_for``) against the dispatch
merge and the JAX package's forced plan.

The plan scores each live part on its own device of a row (here a CPU
row, built directly: ``_plan_for`` refuses a row that reuses a device),
masks dead docs, takes a top-k a part and merges the blocks in shard
order. Held on ``tests/test_replicated.py``'s regime (exhaustive
budgets, unit vectors, k = 9):

* over 1, 2 and 3 parts, bitwise equal (scores, ids and tie order) to
  the port's dispatch merge (``ShardedIndex.search_batch``), also with
  exact ties across parts (duplicated docs) and after a delete;
* against the JAX package's forced plan (``use_shard_map=True`` on its
  one host device: a one-cell program over a monolithic index, the
  dispatch merge over a sharded one): ids equal and scores within 1e-6
  (f32 sums in another order; ids equal tie order included);
* ``_plan_for`` keeps the reference's gates: the flat backend only;
  ``use_shard_map=False`` never; auto needs two live parts on more than
  one device; forced needs a row of distinct devices. On one device a
  forced plan over a sharded index falls back to the dispatch merge, and
  over a monolithic flat index builds a one-cell plan, both equal to
  ``search_batch``; ``add``, ``delete`` and ``close`` drop the plans.
"""
import numpy as np
import pytest
import torch

from repro.core.index import MultiVectorIndex as JIndex
from repro.core.replicated import ReplicatedIndex as JReplicated
from repro.core.sharded import ShardedIndex as JSharded
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.replicated import ReplicatedIndex, _FlatPlan, _parts
from repro_torch.core.sharded import ShardedIndex
from repro_torch.kernels import launch_counts

DIM, K = 16, 9
KW = dict(doc_maxlen=24, n_centroids=16, ndocs=4096, hnsw_candidates=8192)
# shard caps that cut the 50 docs of seed 1 into 1, 2 and 3 parts
CAPS = {1: 0, 2: 350, 3: 250}


def unit_docs(rng, n=50, lo=4, hi=20):
    docs = []
    for _ in range(n):
        v = rng.normal(size=(rng.integers(lo, hi), DIM)).astype(np.float32)
        docs.append(v / np.linalg.norm(v, axis=-1, keepdims=True))
    return docs


def unit_queries(rng, n=6, lq=5):
    q = rng.normal(size=(n, lq, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _port(docs, cap, backend="flat"):
    if cap:
        ix = ShardedIndex(dim=DIM, backend=backend, shard_max_vectors=cap,
                          device="cpu", **KW)
    else:
        ix = MultiVectorIndex(dim=DIM, backend=backend, device="cpu", **KW)
    ix.add([torch.from_numpy(d) for d in docs])
    return ix


def _reference(docs, cap):
    ix = (JSharded(dim=DIM, backend="flat", shard_max_vectors=cap, **KW)
          if cap else JIndex(dim=DIM, backend="flat", **KW))
    ix.add(docs)
    return ix


def _plan(ix):
    parts = _parts(ix)
    return _FlatPlan(parts, ["cpu"] * len(parts))


def _equal(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_plan_bitwise_equals_dispatch_merge(n_parts):
    rng = np.random.default_rng(1)
    docs, qs = unit_docs(rng), unit_queries(rng)
    ix = _port(docs, CAPS[n_parts])
    assert len(_parts(ix)) == n_parts
    plan = _plan(ix)
    q = torch.from_numpy(qs)
    _equal(plan.search(q, None, K), ix.search_batch(q, k=K))
    # a query mask, and k past the corpus (-inf / -1 pads)
    qm = np.ones(qs.shape[:2], bool)
    qm[:, 3:] = False
    _equal(plan.search(q, torch.from_numpy(qm), K),
           ix.search_batch(q, k=K, q_mask=torch.from_numpy(qm)))
    _equal(plan.search(q, None, 64), ix.search_batch(q, k=64))


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_plan_matches_reference_forced_plan(n_parts):
    rng = np.random.default_rng(1)
    docs, qs = unit_docs(rng), unit_queries(rng)
    S, I = _plan(_port(docs, CAPS[n_parts])).search(torch.from_numpy(qs),
                                                     None, K)
    jrep = JReplicated.replicate(_reference(docs, CAPS[n_parts]), 2,
                                 use_shard_map=True)
    for r in range(2):
        jS, jI = jrep.search_batch_on(r, qs, k=K)
        assert np.array_equal(I, jI)
        np.testing.assert_allclose(S, jS, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_plan_keeps_tie_order_across_parts(n_parts):
    """Each doc twice, the copy 25 ids later (mostly in another part):
    every score ties exactly with its copy's; the lower id comes first."""
    rng = np.random.default_rng(1)
    base = unit_docs(rng, n=25)
    docs, qs = base + base, unit_queries(rng)
    ix = _port(docs, CAPS[n_parts])
    assert len(_parts(ix)) == n_parts
    q = torch.from_numpy(qs)
    S, I = _plan(ix).search(q, None, 10)
    _equal((S, I), ix.search_batch(q, k=10))
    assert (S[:, 0::2] == S[:, 1::2]).all()            # pairs of ties
    assert (I[:, 1::2] == I[:, 0::2] + 25).all()        # lower id first
    b1 = _parts(ix)[1][0]                               # copies cross parts
    assert ((I[:, 0::2] < b1) & (I[:, 1::2] >= b1)).mean() > 0.5
    jS, jI = _reference(docs, CAPS[n_parts]).search_batch(qs, k=10)
    assert np.array_equal(I, jI)


def test_plan_after_delete_equals_dispatch_and_reference():
    rng = np.random.default_rng(2)
    docs, qs = unit_docs(rng), unit_queries(rng)
    ix, ref = _port(docs, CAPS[3]), _reference(docs, CAPS[3])
    for x in (ix, ref):
        x.delete([0, 7, 30, 49])
    q = torch.from_numpy(qs)
    S, I = _plan(ix).search(q, None, K)
    _equal((S, I), ix.search_batch(q, k=K))
    jS, jI = ref.search_batch(qs, k=K)
    assert np.array_equal(I, jI) and not np.isin(I, [0, 7, 30, 49]).any()
    np.testing.assert_allclose(S, jS, rtol=0, atol=1e-6)


# ------------------------------------------------------------ the gates
def test_forced_plan_on_one_device():
    """A monolithic flat index: a one-cell plan on every lane; a sharded
    one: the row reuses the device, so the dispatch merge serves."""
    rng = np.random.default_rng(1)
    docs, qs = unit_docs(rng), unit_queries(rng)
    q = torch.from_numpy(qs)
    mono = _port(docs, 0)
    rep = ReplicatedIndex.replicate(mono, 2, use_shard_map=True)
    before = launch_counts()["maxsim"]
    for r in range(2):
        _equal(rep.search_batch_on(r, q, k=K), mono.search_batch(q, k=K))
        assert isinstance(rep._plans[r], _FlatPlan)
        assert len(rep._plans[r].cells) == 1
    assert launch_counts()["maxsim"] == before     # CPU: plain version
    sharded = _port(docs, CAPS[3])
    rep = ReplicatedIndex.replicate(sharded, 2, use_shard_map=True)
    for r in range(2):
        _equal(rep.search_batch_on(r, q, k=K), sharded.search_batch(q, k=K))
        assert rep._plans[r] is None


@pytest.mark.parametrize("flag", [None, False])
def test_auto_and_off_build_no_plan_on_one_device(flag):
    rng = np.random.default_rng(1)
    docs, qs = unit_docs(rng), unit_queries(rng)
    q = torch.from_numpy(qs)
    for cap in (0, CAPS[3]):
        ix = _port(docs, cap)
        rep = ReplicatedIndex.replicate(ix, 2, use_shard_map=flag)
        _equal(rep.search_batch(q, k=K), ix.search_batch(q, k=K))
        assert rep._plan_for(0) is None


def test_plans_only_for_the_flat_backend():
    rng = np.random.default_rng(3)
    docs, qs = unit_docs(rng, n=30), unit_queries(rng)
    q = torch.from_numpy(qs)
    ix = _port(docs, 0, backend="hnsw")
    rep = ReplicatedIndex.replicate(ix, 1, use_shard_map=True)
    _equal(rep.search_batch(q, k=K), ix.search_batch(q, k=K))
    assert rep._plan_for(0) is None


def test_delete_add_and_close_drop_the_plans():
    """``tests/test_replicated.py``'s delete case on monolithic flat
    copies (so the plans exist): delete fans to both copies and drops
    the plans; the rebuilt plans serve the reference's results."""
    rng = np.random.default_rng(2)
    docs, qs = unit_docs(rng), unit_queries(rng)
    q = torch.from_numpy(qs)
    rep = ReplicatedIndex([_port(docs, 0) for _ in range(2)],
                          use_shard_map=True)
    rep.search_batch(q, k=5)
    assert 0 in rep._plans
    rep.delete([0, 7])
    assert rep._plans == {}
    ref = _reference(docs, 0)
    ref.delete([0, 7])
    jS, jI = ref.search_batch(qs, k=5)
    want = _port(docs, 0)
    want.delete([0, 7])
    for r in range(2):
        S, I = rep.search_batch_on(r, q, k=5)
        _equal((S, I), want.search_batch(q, k=5))
        assert np.array_equal(I, jI)
        np.testing.assert_allclose(S, jS, rtol=0, atol=1e-6)
    rep.delete([])                              # well-typed no-op
    _equal(rep.search_batch(q, k=5), want.search_batch(q, k=5))
    shared = ReplicatedIndex.replicate(_port(docs, 0), 2, use_shard_map=True)
    shared.warm_shapes(q, k=5)
    assert set(shared._plans) == {0, 1}
    new = unit_docs(np.random.default_rng(9), n=3)
    ids = shared.add([torch.from_numpy(d) for d in new])
    assert shared._plans == {} and list(ids) == [50, 51, 52]
    S, I = shared.search_batch(torch.from_numpy(new[1][None, :5]), k=1)
    assert I[0, 0] == 51
    shared.close()
    assert shared._plans == {} and shared.closed
