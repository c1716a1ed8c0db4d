"""Ward token pooling, PLAID's centroids and 2-bit residual codec, and
MaxSim, in plain PyTorch.

* Ward pooling (the paper's hierarchical method): a document's emitted
  unit vectors are merged, closest Ward pair first (squared Euclidean
  Lance-Williams linkage; of equal pairs the first in row-major order),
  down to ``n // factor + 1`` clusters; each cluster is stored as the
  renormalised mean of its vectors, in the order of its lowest token.
* Centroids: cosine k-means, ``n_iters`` Lloyd steps from the rows
  ``randperm(M, seed 0)[:K]`` of the pooled vectors (a CPU
  ``torch.Generator``), an empty cluster keeping its centroid.
* Codec (ColBERTv2's residual compression): residuals of a sample of
  ``sample`` rows (``randperm(M, seed 0)[:sample]`` where M is larger)
  to their nearest centroid; the cutoffs are their per-dimension
  quantiles at 1/4, 1/2, 3/4, the values each bucket's mean. A vector
  is stored as its nearest centroid (first of equals) and, per
  dimension, the number of cutoffs strictly below its residual;
  reconstruction is centroid + bucket values, renormalised.
* MaxSim: the sum over query tokens of the best dot product with any
  stored vector of the document.
* PLAID search (``plaid_search``): each query token probes its
  ``nprobe`` best centroids; the candidates are the documents with a
  stored vector on a probed centroid; where there are more than
  ``ndocs``, they are cut to the best ``ndocs`` by the centroid-only
  score (each query token's best centroid score over the document's
  stored vectors, scores under ``t_cs`` read as 0, summed over query
  tokens; of equal scores the lower id); the survivors are scored by
  exact MaxSim over their reconstructed vectors, and the best ``k``
  (of equal scores the lower id) are the answer.

``tf32=True`` is the index stages' control: Ward's distances in f32
from a Gram of TF32-rounded operands, and every nearest-centroid product
from TF32-rounded operands (the step below the f32 these stages state).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (to nearest, ties to
    even)."""
    i = t.float().contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


def _mm(a, b, tf32: bool):
    return tf32_round(a) @ tf32_round(b) if tf32 else a @ b


@torch.no_grad()
def ward_pool(x: torch.Tensor, emit: torch.Tensor, factor: int,
              block: int = 1024, tf32: bool = False):
    """x [N, L, d] unit rows, emit [N, L] -> (pooled [M, d] doc-major,
    counts [N] int64)."""
    rows, counts = [], []
    for lo in range(0, x.shape[0], block):
        r, c = _ward_block(x[lo:lo + block], emit[lo:lo + block], factor,
                           tf32)
        rows.append(r)
        counts.append(c)
    return torch.cat(rows), torch.cat(counts)


def _ward_block(x, emit, factor, tf32=False):
    B, L, _ = x.shape
    dev = x.device
    # trim to the last emitted position of the block
    last = int(torch.nonzero(emit.any(0)).max()) + 1 if bool(emit.any()) \
        else 1
    x, emit = x[:, :last], emit[:, :last]
    x = x.float() if tf32 else x.double()
    L = last
    x = x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-12)
    x = x * emit[..., None]
    d2 = torch.clamp((x * x).sum(-1)[:, :, None] + (x * x).sum(-1)[:, None]
                     - 2 * _mm(x, x.transpose(1, 2), tf32), min=0.0)
    pair = emit[:, :, None] & emit[:, None, :] & ~torch.eye(
        L, dtype=torch.bool, device=dev)
    inf = float("inf")
    d2 = d2.masked_fill(~pair, inf)
    size = emit.to(x.dtype)
    rep = torch.arange(L, device=dev).repeat(B, 1)
    nval = emit.sum(1)
    merges = torch.clamp(nval - (nval // factor + 1), min=0)
    b = torch.arange(B, device=dev)
    lane = torch.arange(L, device=dev)[None]
    for step in range(int(merges.max()) if B else 0):
        flat = torch.argmin(d2.reshape(B, -1), dim=1)
        i, j = flat // L, flat % L
        i, j = torch.minimum(i, j), torch.maximum(i, j)
        dij = d2[b, i, j]
        act = (merges > step) & torch.isfinite(dij)
        si, sj = size[b, i][:, None], size[b, j][:, None]
        di, dj = d2[b, i], d2[b, j]
        new = ((si + size) * di + (sj + size) * dj - size * dij[:, None]) \
            / torch.clamp(si + sj + size, min=1e-12)
        gone = torch.isinf(di) | torch.isinf(dj) | (lane == i[:, None]) \
            | (lane == j[:, None])
        new = new.masked_fill(gone, inf)
        ri = torch.where(act[:, None], new, di)
        rj = torch.where(act[:, None], torch.full_like(dj, inf), dj)
        d2[b, i, :], d2[b, :, i] = ri, ri
        d2[b, j, :], d2[b, :, j] = rj, rj
        size = torch.where(act[:, None] & (lane == i[:, None]), si + sj, size)
        size = torch.where(act[:, None] & (lane == j[:, None]),
                           torch.zeros_like(size), size)
        rep = torch.where(act[:, None] & (rep == j[:, None]), i[:, None], rep)
    # cluster means of the unit vectors, slots by representative token
    sums = torch.zeros_like(x).scatter_add_(
        1, rep[..., None].expand_as(x), x)
    cnt = torch.zeros((B, L), dtype=x.dtype, device=dev).scatter_add_(
        1, rep, emit.to(x.dtype))
    live = cnt > 0
    mean = sums / torch.clamp(cnt, min=1.0)[..., None]
    mean = mean / torch.clamp(mean.norm(dim=-1, keepdim=True), min=1e-12)
    return mean[live].float(), live.sum(1)


def randperm_rows(M: int, k: int, seed: int = 0) -> torch.Tensor:
    return torch.randperm(M, generator=torch.Generator().manual_seed(seed))[:k]


def nearest(x: torch.Tensor, c: torch.Tensor, chunk: int = 1 << 18,
            tf32: bool = False):
    return torch.cat([torch.argmax(_mm(x[lo:lo + chunk], c.T, tf32), dim=1)
                      for lo in range(0, len(x), chunk)])


def _unit(x):
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-9)


@torch.no_grad()
def kmeans(x: torch.Tensor, k: int, n_iters: int, seed: int = 0,
           tf32: bool = False):
    x = _unit(x.float())
    c = x[randperm_rows(len(x), k, seed).to(x.device)]
    for _ in range(n_iters):
        a = nearest(x, c, tf32=tf32)
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add_(0, a, x.double())
        cnt = torch.bincount(a, minlength=k)
        new = _unit((sums / torch.clamp(cnt, min=1)[:, None]).float())
        c = torch.where((cnt > 0)[:, None], new, c)
    return c


@dataclass
class Index:
    counts: torch.Tensor       # [n_docs] stored vectors a doc
    offsets: torch.Tensor      # [n_docs + 1]
    centroids: torch.Tensor    # [K, dim]
    cutoffs: torch.Tensor      # [dim, 2^b - 1]
    values: torch.Tensor       # [dim, 2^b]
    assign: torch.Tensor       # [M] centroid ids
    codes: torch.Tensor        # [M, dim] bucket codes

    def decode(self, rows: torch.Tensor) -> torch.Tensor:
        return decode(self.centroids, self.values, self.assign[rows],
                      self.codes[rows])

    def doc_rows(self, d: int) -> torch.Tensor:
        return torch.arange(int(self.offsets[d]), int(self.offsets[d + 1]),
                            device=self.assign.device)


def decode(centroids, values, assign, codes):
    dims = torch.arange(values.shape[0], device=codes.device)[None]
    return _unit(centroids[assign.long()] + values[dims, codes.long()])


def bucketize(res: torch.Tensor, cutoffs: torch.Tensor) -> torch.Tensor:
    return (res[:, :, None] > cutoffs[None]).sum(-1)


@torch.no_grad()
def build_index(pooled: torch.Tensor, counts: torch.Tensor, n_centroids: int,
                bits: int, n_iters: int = 12, sample: int = 65536,
                seed: int = 0, tf32: bool = False) -> Index:
    """Pooled rows [M, dim] (doc-major) -> the compressed index."""
    M = len(pooled)
    c = kmeans(pooled, min(n_centroids, M), n_iters, seed, tf32)
    train = pooled
    if M > sample:
        train = pooled[randperm_rows(M, sample, seed).to(pooled.device)]
    res = train - c[nearest(train, c, tf32=tf32)]
    nb = 1 << bits
    qs = torch.arange(1, nb, dtype=torch.float32, device=res.device) / nb
    cutoffs = torch.quantile(res, qs, dim=0).T.contiguous()
    code = bucketize(res, cutoffs)
    dim = res.shape[1]
    seg = code + torch.arange(dim, device=res.device)[None] * nb
    sums = torch.zeros(dim * nb, dtype=torch.float64, device=res.device
                       ).index_add_(0, seg.reshape(-1),
                                    res.reshape(-1).double())
    cnt = torch.bincount(seg.reshape(-1), minlength=dim * nb)
    values = (sums / torch.clamp(cnt, min=1)).float().reshape(dim, nb)
    assign, codes = [], []
    for lo in range(0, M, 1 << 18):
        v = pooled[lo:lo + (1 << 18)]
        a = nearest(v, c, tf32=tf32)
        assign.append(a)
        codes.append(bucketize(v - c[a], cutoffs).to(torch.uint8))
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int64,
                          device=pooled.device)
    offsets[1:] = torch.cumsum(counts.to(pooled.device), 0)
    return Index(counts=counts, offsets=offsets, centroids=c,
                 cutoffs=cutoffs, values=values, assign=torch.cat(assign),
                 codes=torch.cat(codes))


def _doc_max(vals: torch.Tensor, doc: torch.Tensor,
             n_docs: int) -> torch.Tensor:
    """vals [b, Lq, M] over stored vectors, doc [M] their documents ->
    [b, Lq, n_docs], the largest over each document's vectors."""
    b, Lq, M = vals.shape
    out = vals.new_full((b, Lq, n_docs), float("-inf"))
    return out.scatter_reduce_(2, doc.expand(b, Lq, M), vals, "amax")


@torch.no_grad()
def plaid_search(ix: Index, q: torch.Tensor, nprobe: int, t_cs: float,
                 ndocs: int, k: int, block: int = 8, tf32: bool = False):
    """q [B, Lq, dim] -> (scores [B, k], ids [B, k], exact MaxSim of
    every document [B, n_docs]) by the staged search of the module's
    docstring (``tf32``: its products from TF32-rounded operands)."""
    n_docs, K = len(ix.counts), len(ix.centroids)
    dev = q.device
    doc = torch.repeat_interleave(torch.arange(n_docs, device=dev),
                                  ix.counts.to(dev))
    member = torch.zeros((K, n_docs), dtype=torch.float32, device=dev)
    member[ix.assign.long(), doc] = 1.0
    recon = decode(ix.centroids, ix.values, ix.assign, ix.codes)
    scores, ids, exact = [], [], []
    for lo in range(0, len(q), block):
        qb = q[lo:lo + block].float()
        cs = _mm(qb, ix.centroids.T, tf32)                    # [b, Lq, K]
        probe = cs.topk(min(nprobe, K), dim=-1).indices
        probed = torch.zeros((len(qb), K), device=dev).scatter_(
            1, probe.reshape(len(qb), -1), 1.0)
        cand = (probed @ member) > 0                          # [b, n_docs]
        csp = torch.where(cs >= t_cs, cs, torch.zeros((), device=dev))
        approx = _doc_max(csp[:, :, ix.assign.long()], doc, n_docs).sum(1)
        approx = approx.masked_fill(~cand, float("-inf"))
        order = torch.sort(approx, dim=1, descending=True, stable=True)[1]
        keep = torch.zeros_like(cand).scatter_(1, order[:, :ndocs], True)
        ex = _doc_max(_mm(qb, recon.T, tf32), doc, n_docs).sum(1)
        s = ex.masked_fill(~(keep & cand), float("-inf"))
        top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
        scores.append(top_s[:, :k])
        ids.append(top_i[:, :k])
        exact.append(ex)
    return torch.cat(scores), torch.cat(ids), torch.cat(exact)


def maxsim(q: torch.Tensor, docs) -> torch.Tensor:
    """q [Lq, dim]; docs: list of [n_i, dim] -> scores [len(docs)] f32."""
    return torch.stack([(q @ d.T).amax(dim=1).sum() for d in docs])


def unpack_words(words: np.ndarray, bits: int, dim: int) -> np.ndarray:
    """Packed uint32 words [M, W], little-endian lanes -> codes [M, dim]."""
    lanes = 32 // bits
    shifts = (np.arange(lanes, dtype=np.uint32) * bits)[None, None]
    c = (words.astype(np.uint32)[:, :, None] >> shifts) & ((1 << bits) - 1)
    return c.reshape(len(words), dim).astype(np.uint8)
