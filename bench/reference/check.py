"""The comparison that decides ``correct``.

Ward's greedy merges are discontinuous in their input: the bf16
encodings the configurations state change a merge in most documents
against f32 ones, so an index worked out from an independent f32
encoding cannot be compared with the program's vector by vector. The
reference therefore checks the encoder by itself, and follows the
program from its document encodings for the stages after it:

* ``encode_gap``: the encoder by itself. Over a sample of documents
  drawn from the seed, the widest distance between a token vector of
  the program's encodings and the reference's f32 encoding of it.
* From the program's encodings the reference works out the pooled
  vectors, the centroids, the codec and the codes again
  (``Reference.index_from``).

A build's artifact, read back from its directory, is then judged by
``count_err`` (documents whose stored vector count differs from the
reference's, and any missing or extra document; limit 0),
``centroid_gap`` (the median over centroids of the distance between the
artifact's centroid and the reference's) and ``score_gap_mean`` (the
mean gap, over a sample of documents and the reference's f32 queries,
between the MaxSim the artifact's reconstruction gives and the one the
reference's index gives, per query token).

A search is judged on its encoder by itself (``encode_gap``, as a
build) and on its search stage followed from the program's index as it
was searched (its artifact, written at set-up). Ward's merges and the
Lloyd steps of a crowded centroid can go another way between the
program's f32 and the reference's f64 sums, and where that moves most
documents of a seed (PERF.md) an index worked out again would judge
the index build a second time, and badly; ``Indexer.build`` is the
build cell's to check, and what the comparison reads against the
reference's own index stays among the readings. The numbers:
``missing`` (requests due in the window that never came, failed, or
came malformed: fewer than k results, a repeated or invalid id, scores
not descending; limit 0), ``score_gap_median`` (the median gap, over a
sample of answers drawn from the seed and their k documents, between
each returned score and the reference's MaxSim of that document from
the reference's f32 encoding of the query, per query token) and
``rank_gap`` (which documents were answered: the reference runs its
own PLAID search, probe, centroid-only prune and exact MaxSim, for
each sampled query; the mean, over the sample, of the gap between the
sum of its k best scores and the sum of its scores of the k documents
answered, per query token and slot). ``score_gap_median`` holds the
scores to the documents answered; ``rank_gap`` holds the documents to
the best ones, so a wrong slate, prune or top-k fails it with right
scores.

The widest score gap is a reading, not a number compared: it falls on
the few documents where a Ward merge or a centroid's Lloyd steps went
another way between the program's f32 and the reference's f64 sums
(``moved_docs``), and swings with them from seed to seed.

Two controls stand in the program's place, each a step below a
precision the configuration states. ``Reference("fp8")`` (the encoder's
bf16): its encodings are the ones followed, its index is worked out
from them, and its search answers are its own PLAID search of the
followed index from its own query encodings. ``Reference("tf32")``
(the index stages' f32): it follows the program's encodings, works out
the build's index with TF32 products, and answers a search by its PLAID
search of the followed index with TF32 products.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from bench.reference import encoder
from bench.reference.index import (Index, build_index, decode, plaid_search,
                                   unpack_words, ward_pool)


class Reference:
    def __init__(self, precision: str, weights: dict, cfg: dict):
        self.prec = encoder.Precision(precision)
        self.w = weights
        self.cfg = cfg
        self.model = cfg["model"]

    @torch.no_grad()
    def encode_docs(self, doc_tokens: np.ndarray, device):
        return encoder.encode_docs(self.w, self.model,
                                   torch.as_tensor(doc_tokens, device=device),
                                   self.prec)

    @torch.no_grad()
    def queries(self, q_tokens: np.ndarray, device) -> torch.Tensor:
        return encoder.encode_queries(
            self.w, self.model, torch.as_tensor(q_tokens, device=device),
            self.prec)

    @torch.no_grad()
    def index_from(self, x: torch.Tensor, emit: torch.Tensor) -> Index:
        """Ward pooling, centroids, codec and codes from encodings x
        [N, L, dim] (emit [N, L])."""
        tf32 = self.prec.tf32
        pooled, counts = ward_pool(x, emit, self.cfg["pooling"]["factor"],
                                   tf32=tf32)
        ix = self.cfg["index"]
        return build_index(pooled, counts, ix["n_centroids"],
                           ix["quant_bits"], ix["kmeans_iters"],
                           ix["codec_sample"], tf32=tf32)


def read_artifact(path: str, device) -> Index:
    """A plaid artifact's codec, codes and offsets, read with numpy from
    its manifest's payload table."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    arr = {name: np.load(os.path.join(path, p["file"]))
           for name, p in manifest["payloads"].items()}
    bits = int(manifest["codec_bits"])
    dim = arr["codec_centroids"].shape[1]
    offsets = torch.as_tensor(arr["doc_offsets"].astype(np.int64),
                              device=device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return Index(counts=offsets[1:] - offsets[:-1], offsets=offsets,
                 centroids=t(arr["codec_centroids"]).float(),
                 cutoffs=t(arr["codec_cutoffs"]).float(),
                 values=t(arr["codec_values"]).float(),
                 assign=t(arr["assignments"].astype(np.int64)),
                 codes=t(unpack_words(arr["codes"], bits, dim)))


def doc_scores(ix: Index, q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """MaxSim of queries q [S, Lq, dim] against documents docs [S, m]
    (query s against its own row) -> [S, m]."""
    cnt = ix.counts[docs]
    Lmax = max(int(cnt.max()), 1)
    pos = torch.arange(Lmax, device=docs.device)
    valid = pos[None, None] < cnt[..., None]
    rows = torch.where(valid, ix.offsets[docs][..., None] + pos, 0)
    v = decode(ix.centroids, ix.values, ix.assign[rows], ix.codes[rows])
    sims = torch.einsum("sld,smjd->smlj", q, v)
    sims = sims.masked_fill(~valid[:, :, None, :], float("-inf"))
    return sims.amax(-1).sum(-1)


def encode_gap(got_x: torch.Tensor, want_x: torch.Tensor,
               emit: torch.Tensor) -> float:
    """Widest distance between emitted token vectors [n, L, dim]."""
    d = (got_x - want_x).norm(dim=-1)
    return float(d[emit].max()) if bool(emit.any()) else 0.0


def _sample(seed: int, salt: int, n: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, salt]))
    return np.sort(rng.choice(n, min(k, n), replace=False))


def _stats(gap: torch.Tensor) -> dict:
    g = gap.flatten().double()
    return {"max": float(g.max()), "p99": float(torch.quantile(g, 0.99)),
            "mean": float(g.mean()), "median": float(g.median())}


def build_numbers(ref: Index, got: Index, q: torch.Tensor,
                  sample: np.ndarray):
    """-> (numbers, readings) of a built index ``got`` against ``ref``."""
    n_ref, n_got = len(ref.counts), len(got.counts)
    n = min(n_ref, n_got)
    same = ref.counts[:n].cpu() == got.counts[:n].cpu()
    count_err = int((~same).sum()) + abs(n_ref - n_got)
    if got.centroids.shape == ref.centroids.shape:
        cgap = (got.centroids - ref.centroids).norm(dim=1)
        centroid_gap, centroid_max = float(cgap.median()), float(cgap.max())
    else:
        centroid_gap = centroid_max = float("inf")
    docs = torch.as_tensor(sample[sample < n], device=q.device)
    if not len(docs):
        return ({"count_err": count_err, "centroid_gap": centroid_gap,
                 "score_gap_mean": float("inf")}, {})
    gaps = torch.cat([(doc_scores(got, q[i:i + 1], docs[None])
                       - doc_scores(ref, q[i:i + 1], docs[None])).abs()
                      for i in range(len(q))]) / q.shape[1]
    g = _stats(gaps)
    return ({"count_err": count_err, "centroid_gap": centroid_gap,
             "score_gap_mean": g["mean"]},
            {"centroid_gap_max": centroid_max, "score_gap_max": g["max"],
             "score_gap_p99": g["p99"],
             "moved_docs": _moved_docs(ref, got, docs[same[docs.cpu()]
                                                      .to(docs.device)])})


def _moved_docs(ref: Index, got: Index, docs: torch.Tensor) -> float:
    """Share of documents (of equal counts) with a stored vector whose
    two reconstructions lie more than 0.1 apart: a Ward merge or a
    centroid that went another way, not rounding."""
    moved = 0
    for d in docs.tolist():
        r = ref.doc_rows(d)
        a = decode(ref.centroids, ref.values, ref.assign[r], ref.codes[r])
        b = decode(got.centroids, got.values, got.assign[r], got.codes[r])
        moved += bool(((a - b).norm(dim=1) > 0.1).any())
    return moved / max(len(docs), 1)


def malformed(scores: np.ndarray, ids: np.ndarray, k: int,
              n_docs: int) -> bool:
    return bool(len(ids) != k or (ids < 0).any() or (ids >= n_docs).any()
                or len(np.unique(ids)) != k or not np.isfinite(scores).all()
                or (np.diff(scores) > 0).any())


def search_gaps(ref: Index, ref_q: torch.Tensor, answers: list) -> dict:
    """answers: (query index, scores [k], ids [k]) -> gap statistics."""
    dev = ref_q.device
    qi = torch.as_tensor([a[0] for a in answers], device=dev)
    got = torch.as_tensor(np.stack([a[1] for a in answers]), device=dev)
    ids = torch.as_tensor(np.stack([a[2] for a in answers]), device=dev)
    ids = ids.clamp(0, len(ref.counts) - 1)
    gaps = [(got[lo:lo + 64].float()
             - doc_scores(ref, ref_q[qi[lo:lo + 64]], ids[lo:lo + 64])).abs()
            for lo in range(0, len(qi), 64)]
    return _stats(torch.cat(gaps) / ref_q.shape[1])


def _encodings(job, control, tokens, dev):
    """(the encodings followed: the fp8 control's own, else the
    program's; the rows of the sample the encoder is checked on)."""
    if control is not None and control.prec.fp8:
        x, emit = control.encode_docs(tokens, dev)
    else:
        x, emit = job.encodings
    pick = _sample(job.seed, 17, len(tokens), job.traffic["check_encode"])
    rows = torch.as_tensor(pick, device=dev)
    return x, emit, rows


def judge_build(job, ref: Reference, control: Reference = None):
    dev = job.device
    tokens = job.slices[job.last_slice]
    x, emit, rows = _encodings(job, control, tokens, dev)
    want_x, _ = ref.encode_docs(tokens[rows.cpu().numpy()], dev)
    e_gap = encode_gap(x[rows], want_x, emit[rows])
    want = ref.index_from(x, emit)
    if control is None:
        got = read_artifact(job.out_dir, dev)
    else:
        got = want if control.prec.fp8 else control.index_from(x, emit)
    q = ref.queries(job.check_queries, dev)
    sample = _sample(job.seed, 13, len(tokens), job.traffic["check_docs"])
    numbers, readings = build_numbers(want, got, q, sample)
    return dict(numbers, encode_gap=e_gap), readings


def rank_gaps(ix: Index, ref_q: torch.Tensor, answers: list, spec: dict,
              k: int, tf32: bool = False):
    """The reference's PLAID search (``plaid_search``, the
    configuration's nprobe, t_cs and ndocs) over index ``ix`` for each
    answered query, against the ids answered: per answer the gap between
    the sum of the reference's k best scores and the sum of the
    reference's scores of the k documents answered, per query token and
    answer slot -> (mean gap, readings). A slate, a prune or a top-k that
    misses the best documents reads above 0 whatever scores it reports;
    equal documents in another order read 0."""
    dev = ref_q.device
    qi = np.asarray([a[0] for a in answers])
    uq, row = np.unique(qi, return_inverse=True)
    best_s, best_i, exact = plaid_search(
        ix, ref_q[torch.as_tensor(uq, device=dev)], spec["nprobe"],
        spec["t_cs"], spec["ndocs"], 2 * k, tf32=tf32)
    row = torch.as_tensor(row, device=dev)
    ids = torch.as_tensor(np.stack([a[2] for a in answers]), device=dev)
    ids = ids.clamp(0, len(ix.counts) - 1)
    got = torch.gather(exact[row], 1, ids)
    norm = k * ref_q.shape[1]
    gap = (best_s[row, :k].sum(1) - got.sum(1)) / norm
    # what answering the reference's next k would read: a wrong top-k
    next_k = (best_s[row, :k].sum(1) - best_s[row, k:].sum(1)) / norm
    next_k = next_k[torch.isfinite(next_k)]
    full = exact.topk(k, dim=1)
    hit = (ids[:, :, None] == best_i[row, None, :k]).any(-1).float()
    hit_all = (ids[:, :, None] == full.indices[row, None, :]).any(-1).float()
    return float(gap.mean()), {
        "rank_gap_median": float(gap.median()),
        "rank_gap_max": float(gap.max()),
        "rank_gap_next_k": (float(next_k.mean()) if len(next_k)
                            else float("nan")),
        "recall_vs_ref": float(hit.mean()),
        "recall_vs_exhaustive": float(hit_all.mean()),
        "ref_recall_vs_exhaustive": float(
            (best_i[:, :k, None] == full.indices[:, None, :]).any(-1)
            .float().mean())}


def judge_search(job, ref: Reference, control: Reference = None):
    """The encoder by itself (``encode_gap``), then the search stage
    followed from the program's index as it was searched (its artifact,
    written at set-up): the answers' scores and documents against the
    reference's PLAID search of that index with the reference's f32
    query encodings. The index build it skips is ``Indexer.build``, which
    the build cell checks by itself; what the same comparison reads
    against the reference's own index is kept among the readings."""
    dev = job.device
    k = job.traffic["k"]
    n_docs = len(job.docs)
    answers = list(job.answers())
    bad = sum(malformed(np.asarray(s), np.asarray(i), k, n_docs)
              for _, s, i in answers)
    missing = job.attempted - len(answers) + bad
    x, emit, rows = _encodings(job, control, job.docs, dev)
    want_x, _ = ref.encode_docs(job.docs[rows.cpu().numpy()], dev)
    e_gap = encode_gap(x[rows], want_x, emit[rows])
    own = ref.index_from(x, emit)
    del x
    chosen = [answers[int(p)] for p in job.sample(len(answers))]
    if not chosen:
        return ({"missing": missing, "encode_gap": e_gap,
                 "score_gap_median": float("inf"),
                 "rank_gap": float("inf")}, {})
    followed = read_artifact(job.out_dir, dev)
    spec = job.cfg["index"]
    if control is not None:
        # the control answers the sampled queries in the program's place
        cq = control.queries(job.queries, dev)
        qi = torch.as_tensor([a[0] for a in chosen], device=dev)
        cs, cids, _ = plaid_search(followed, cq[qi], spec["nprobe"],
                                   spec["t_cs"], spec["ndocs"], k,
                                   tf32=control.prec.tf32)
        cs, cids = cs.cpu().numpy(), cids.cpu().numpy()
        chosen = [(a[0], cs[j], cids[j]) for j, a in enumerate(chosen)]
    rq = ref.queries(job.queries, dev)
    g = search_gaps(followed, rq, chosen)
    r_gap, r_read = rank_gaps(followed, rq, chosen, spec, k)
    g_own = search_gaps(own, rq, chosen)
    r_own, _ = rank_gaps(own, rq, chosen, spec, k)
    return ({"missing": missing, "encode_gap": e_gap,
             "score_gap_median": g["median"], "rank_gap": r_gap},
            dict({"score_gap_max": g["max"], "score_gap_p99": g["p99"],
                  "score_gap_mean": g["mean"],
                  "own_index_score_gap_median": g_own["median"],
                  "own_index_rank_gap": r_own}, **r_read))
