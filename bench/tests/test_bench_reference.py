"""The reference against the program at the SMOKE size on the CPU, the
controls in the program's place, and the check with the timed path
broken underneath: each run drives ``run.run_cell`` as the harness does
past its look for a card."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench.run import run_cell  # noqa: E402
from bench.smoke import smoke_spec  # noqa: E402

CELLS = ("colbertv2.build", "jacolbertv2.search-batch")
SEED = 2 ** 31 + 12345


def _run(cell, tmp_path, dtype="bfloat16", control=None, seed=SEED,
         readings=False, **index):
    spec = smoke_spec(cell)
    spec["cfg"]["model"]["compute_dtype"] = dtype
    spec["cfg"]["index"].update(index)
    spec["work_dir"] = str(tmp_path / "work")
    result, numbers, read = run_cell(spec, seed, 0.3, False, "cpu",
                                     time.perf_counter(), control=control)
    return (result, numbers, read) if readings else (result, numbers)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_program_in_f32(cell, tmp_path):
    """With the encoder in f32 the program and the reference agree to
    rounding at every stage: the reference follows the same semantics."""
    result, numbers = _run(cell, tmp_path, dtype="float32")
    assert result["correct"]
    for k, v in numbers.items():
        assert v <= (0 if k in ("missing", "count_err") else 1e-5), (k, v)


@pytest.mark.parametrize("ndocs", [12, 32, 1024])
def test_reference_search_follows_the_program_in_f32(ndocs, tmp_path):
    """The reference's own PLAID search (probe, centroid-only prune to
    ndocs, exact rerank, top-k) returns the program's documents, with the
    prune cutting hard, cutting and not reached."""
    _, numbers, read = _run("jacolbertv2.search-batch", tmp_path,
                            dtype="float32", readings=True, ndocs=ndocs)
    assert numbers["rank_gap"] == 0.0
    assert read["recall_vs_ref"] == 1.0
    if ndocs == 12:     # the prune binds: PLAID misses some of the best
        assert read["ref_recall_vs_exhaustive"] < 1.0


def test_build_judges_the_timed_builds_encodings(tmp_path):
    """The build cell's check reads the encodings of its last timed
    build, equal to encoding its documents again, and leaves the
    program's encoder as it found it."""
    import repro_torch.retrieval.indexer as indexer
    from bench import jobs
    inner = indexer.encode_docs
    spec = smoke_spec("colbertv2.build")
    t = spec["traffic"]
    job = jobs.BuildJob("colbertv2.build", spec["cfg"], t, SEED, "cpu",
                        str(tmp_path / "work"))
    job.setup()
    job.window(0.0)
    job.keep_state()
    assert indexer.encode_docs is inner
    _, (x, emit) = job.encode(job.slices[job.last_slice])
    assert x.shape[0] == t["docs_per_build"]
    assert (job.encodings[0] == x).all() and (job.encodings[1] == emit).all()
    job.release()


@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_separated(cell, tmp_path):
    """The bf16 program passes; the fp8 control reads its encoder gap at
    least three times the program's. (The tf32 control's readings come
    from the card: at this size the index stages meet too few near ties
    to tell TF32 from f32.)"""
    result, numbers = _run(cell, tmp_path)
    assert result["correct"], result["check"]
    _, fp8 = _run(cell, tmp_path, control="fp8")
    assert fp8["encode_gap"] >= 3 * numbers["encode_gap"]


def _kmeans_unchanged(monkeypatch):
    import repro_torch.core.ivf as ivf
    inner = ivf.kmeans_train
    monkeypatch.setattr(ivf, "kmeans_train",
                        lambda x, k, n_iters=12, **kw: inner(x, k, 0, **kw))


def _pool_half(monkeypatch):
    import repro_torch.core.pooling as pooling
    inner = pooling._mean_pool_by_assign

    def half(x, mask, assign, n, renormalize=True):
        keep = (np.arange(mask.shape[1]) % 2 == 0)
        import torch
        return inner(x, mask & torch.as_tensor(keep)[None], assign, n,
                     renormalize)
    monkeypatch.setattr(pooling, "_mean_pool_by_assign", half)


def _codes_altered(monkeypatch):
    import repro_torch.core.plaid as plaid
    inner = plaid.encode

    def altered(codec, vectors):
        a, w = inner(codec, vectors)
        return (a + 1) % codec.n_centroids, w
    monkeypatch.setattr(plaid, "encode", altered)


def _search_patch(monkeypatch, change):
    from repro_torch.core.index import MultiVectorIndex
    inner = MultiVectorIndex.search_batch
    memo = {}

    def patched(self, qs, k=10, q_mask=None, impl="auto"):
        S, I = inner(self, qs, k=k, q_mask=q_mask, impl=impl)
        return change(S.copy(), I.copy(), memo, self.n_docs)
    monkeypatch.setattr(MultiVectorIndex, "search_batch", patched)


def _stale(S, I, memo, n):
    """Each call answers with the call before it's state."""
    prev = memo.get("last", (S, I))
    memo["last"] = (S, I)
    return prev


def _half_left_out(S, I, memo, n):
    h = (len(S) + 1) // 2
    S[h:], I[h:] = -np.inf, -1
    return S, I


def _ids_altered(S, I, memo, n):
    return S, (I + 1) % n


def _encoder_altered(monkeypatch):
    """The build's encoder off by an fp8-grade error."""
    import torch
    import repro_torch.retrieval.indexer as indexer
    inner = indexer.encode_docs

    def altered(model, chunk):
        v, emit = inner(model, chunk)
        v = v + 0.1 * torch.roll(v, 1, dims=-1)
        return v / v.norm(dim=-1, keepdim=True), emit
    monkeypatch.setattr(indexer, "encode_docs", altered)


def _next_k(monkeypatch):
    """The top-k answers the next k documents, with their own scores."""
    import repro_torch.core.index as index
    inner = index.topk_with_pads

    def next_k(scores, cand, k):
        S, I = inner(scores, cand, 2 * k)
        return S[:, k:], I[:, k:]
    monkeypatch.setattr(index, "topk_with_pads", next_k)


def _prune_inverted(monkeypatch):
    """The prune keeps the ndocs worst candidates by centroid score."""
    import torch
    import repro_torch.core.plaid as plaid
    inner = plaid.plaid_probe_scores

    def inverted(*args, **kw):
        a = inner(*args, **kw)
        return torch.where(torch.isfinite(a), -a, a)
    monkeypatch.setattr(plaid, "plaid_probe_scores", inverted)


BUILD_FAULTS = {"state_unchanged": _kmeans_unchanged,
                "half_left_out": _pool_half, "answer_altered": _codes_altered,
                "encoder_altered": _encoder_altered}
SEARCH_FAULTS = {"state_unchanged": _stale, "half_left_out": _half_left_out,
                 "answer_altered": _ids_altered}
# wrong documents, each with its right score
SELECTION_FAULTS = {"top_k_next": _next_k, "prune_inverted": _prune_inverted}


@pytest.mark.parametrize("fault", sorted(BUILD_FAULTS))
def test_build_faults_are_not_correct(fault, tmp_path, monkeypatch):
    BUILD_FAULTS[fault](monkeypatch)
    result, _ = _run("colbertv2.build", tmp_path)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", CELLS[1:])
@pytest.mark.parametrize("fault", sorted(SEARCH_FAULTS))
def test_search_faults_are_not_correct(cell, fault, tmp_path, monkeypatch):
    _search_patch(monkeypatch, SEARCH_FAULTS[fault])
    result, _ = _run(cell, tmp_path)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("fault", sorted(SELECTION_FAULTS))
def test_wrong_documents_with_right_scores_are_not_correct(
        fault, tmp_path, monkeypatch):
    """A top-k or a prune that picks the wrong documents, each reported
    with its right score: the scores pass, ``rank_gap`` fails."""
    SELECTION_FAULTS[fault](monkeypatch)
    result, numbers = _run("jacolbertv2.search-batch", tmp_path)
    limits = smoke_spec("jacolbertv2.search-batch")["limits"]
    assert numbers["score_gap_median"] <= limits["score_gap_median"]
    assert numbers["rank_gap"] > limits["rank_gap"]
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("nprobe,ndocs,k,want", [
    (1, 8, 2, [0, 2]),        # the probe: doc 1's centroid is not probed
    (2, 1, 1, [0]),           # the prune: of equal centroid scores, id 0
    (2, 8, 3, [0, 2, 1]),     # every doc, best first, equal ones by id
])
def test_reference_plaid_search_by_hand(nprobe, ndocs, k, want):
    """The reference's staged search on three one-vector documents over
    two centroids, whose reconstructions are the centroids."""
    import torch
    from bench.reference.index import Index, plaid_search
    ix = Index(counts=torch.tensor([1, 1, 1]),
               offsets=torch.tensor([0, 1, 2, 3]),
               centroids=torch.tensor([[1.0, 0.0], [0.0, 1.0]]),
               cutoffs=torch.zeros((2, 1)), values=torch.zeros((2, 2)),
               assign=torch.tensor([0, 1, 0]),
               codes=torch.zeros((3, 2), dtype=torch.uint8))
    q = torch.tensor([[[0.8, 0.6]]])
    s, i, exact = plaid_search(ix, q, nprobe, 0.3, ndocs, k)
    assert i[0].tolist() == want
    assert torch.allclose(exact[0], torch.tensor([0.8, 0.6, 0.8]))
    assert torch.allclose(s[0], exact[0][i[0]])
