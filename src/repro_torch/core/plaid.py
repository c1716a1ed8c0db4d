"""PLAID-style staged late-interaction search (Santhanam et al., 2022).

Counterpart of ``src/repro/core/plaid.py``:

  1. centroid probe — every query token scores all K centroids
     (``_centroid_scores_batch``), top-``nprobe`` ids per token;
  2. candidate generation — on the device, probed-centroid rows times
     the 0/1 ``doc_member`` table give each query's candidate docs,
     compacted ascending (``_device_candidates``); on the host path, a
     vectorized numpy walk of the inverted lists (``_gather_candidates``);
  3. approximate scoring and prune — when the candidate ladder exceeds
     ``ndocs``, the ``plaid_probe`` kernel scores candidates from their
     centroid ids alone and the best ``ndocs`` survive (both paths);
  4. exact rerank from packed codes — the ``maxsim_packed`` kernel
     (``maxsim_packed_rerank_store``), or from the f32 reconstruction
     store (``recon_store``) with the ``maxsim_rerank`` kernel.

``device_probe_plan`` takes the device path only where its slates are
provably the host path's and ``doc_member`` fits the gather cap
(``probe_kernel="auto"``): at K = 256 the cap of 2**24 elements allows
65,536 docs, and larger corpora take the host path. Index arrays the
search reads live on the index's device; the IVF bookkeeping is host
numpy, as in the reference. ``PLAIDIndex.add_flat`` encodes new docs
with the index's codec and appends them (``add`` takes the reference's
list of per-doc arrays); ``delete`` compacts (doc ids shift). Both drop
the cached device views (the packed view and the device IVF), so the
next search plans on the new lists. The device
path's stages run inside ``torch.profiler`` ranges named ``search.*``
(no cost without a profiler), so a trace splits one batch's time by
stage. ``plaid_search_batch`` and ``plaid_search`` run the four stages
on a bare ``PLAIDIndex`` (no deletions) and take the top-k.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.docstore import (DocStore, pad_candidate_sets,
                                       padded_scatter_index, ragged_arange)
from repro_torch.core.ivf import (DeviceInvertedLists, InvertedLists,
                                  build_device_inverted_lists,
                                  build_inverted_lists)
from repro_torch.core.maxsim import stable_topk, topk_with_pads
from repro_torch.core.quantization import ResidualCodec, decode, encode
from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores

_CAND_BLOCK = 32       # candidate-axis padding granularity
PROBE_KERNELS = ("auto", "device", "host")
# "auto" takes the host path above this many doc_member elements
# (K * n_docs f32); "device" forces the device path through it
_DEVICE_GATHER_CAP = 1 << 24
_DECODE_CHUNK = 1 << 18     # code rows per recon-store decode pass


@dataclass
class PLAIDIndex:
    codec: ResidualCodec
    ivf: InvertedLists
    assignments: torch.Tensor    # [n_vectors] int32 centroid ids (device)
    codes: torch.Tensor          # [n_vectors, W] int32 packed words (device)
    vec2doc: np.ndarray          # [n_vectors] int64 doc id (host)
    doc_offsets: np.ndarray      # [n_docs + 1] int64 (host)
    doc_maxlen: int
    recon: Optional[DocStore] = None     # f32 reconstruction cache, lazy
    _packed_padded: Optional[Tuple] = field(default=None, repr=False)
    _device_ivf: Optional[DeviceInvertedLists] = field(default=None,
                                                       repr=False)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def n_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def n_vectors(self) -> int:
        return len(self.vec2doc)

    def nbytes(self) -> int:
        """Resident bytes: ids, packed codes, IVF and doc offsets and the
        centroids, plus the f32 reconstruction cache while it is built
        (the reference's count)."""
        total = (self.assignments.numel() * 4 + self.codes.numel() * 4
                 + self.ivf.ids.nbytes + self.ivf.offsets.nbytes
                 + self.vec2doc.nbytes + self.doc_offsets.nbytes
                 + self.codec.centroids.numel() * 4)
        if self.recon is not None:
            total += self.recon.nbytes(bytes_per_dim=4, live_only=False)
        return total

    def _padded_len(self) -> int:
        """Tight padded width L = min(doc_maxlen, longest doc)."""
        lens = np.diff(self.doc_offsets)
        return int(min(self.doc_maxlen, max(lens.max(initial=0), 1)))

    def padded_packed(self) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """Cached device view (ids [n, L] int32, words [n, L, W] int32,
        mask [n, L] bool), L the tight width: what stages 3 and 4 gather
        from."""
        if self._packed_padded is None:
            n, W, dev = self.n_docs, self.codes.shape[1], self.device
            L = self._padded_len()
            ids = torch.zeros((max(n, 1), L), dtype=torch.int32, device=dev)
            words = torch.zeros((max(n, 1), L, W), dtype=torch.int32,
                                device=dev)
            mask = torch.zeros((max(n, 1), L), dtype=torch.bool, device=dev)
            if n and self.n_vectors:
                r, c, s = padded_scatter_index(self.doc_offsets, L, dev)
                ids[r, c] = self.assignments[s]
                words[r, c] = self.codes[s]
                mask[r, c] = True
            self._packed_padded = (ids, words, mask)
        return self._packed_padded

    def _decode_docs(self) -> torch.Tensor:
        """Every code row decoded on the device -> [n_vectors, dim] f32
        (``quantization.decode``, in chunks)."""
        parts = [decode(self.codec, self.assignments[lo:lo + _DECODE_CHUNK],
                        self.codes[lo:lo + _DECODE_CHUNK])
                 for lo in range(0, self.n_vectors, _DECODE_CHUNK)]
        if not parts:
            return torch.zeros((0, self.codec.dim), device=self.device)
        return torch.cat(parts)

    def recon_store(self) -> DocStore:
        """f32 reconstruction cache, built on first use: what the dense
        corpus-wide scoring and ``packed_rerank=False`` read. Packed
        serving never builds it."""
        if self.recon is None:
            self.recon = DocStore.from_arrays(
                self._decode_docs(), self.doc_offsets,
                np.ones(self.n_docs, bool), self.doc_maxlen)
        return self.recon

    def padded_codes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, _, mask = self.padded_packed()
        return ids, mask

    def device_ivf(self, list_cap: int = 0) -> DeviceInvertedLists:
        """Cached exact device IVF (``list_cap=0``), what the device
        candidate path reads; a capped view (``list_cap > 0``, for
        footprint experiments) is built anew and bypasses the cache."""
        if list_cap:
            return build_device_inverted_lists(
                self.ivf, self.vec2doc, self.n_docs, list_cap,
                device=self.device)
        if self._device_ivf is None:
            self._device_ivf = build_device_inverted_lists(
                self.ivf, self.vec2doc, self.n_docs, device=self.device)
        return self._device_ivf

    def _invalidate(self) -> None:
        self._packed_padded = None
        self._device_ivf = None

    # ------------------------------------------------------------------ CRUD
    def add(self, doc_vectors) -> np.ndarray:
        """Append docs given as a list of [n_i, dim] arrays or tensors (the
        reference's form) -> their new ids; ``add_flat`` of their rows."""
        dim = self.codec.dim
        flat = (torch.cat([torch.as_tensor(v).to(self.device, torch.float32)
                           .reshape(-1, dim) for v in doc_vectors])
                if len(doc_vectors) else
                torch.zeros((0, dim), device=self.device))
        return self.add_flat(flat, [len(v) for v in doc_vectors])

    def add_flat(self, flat: torch.Tensor, lens) -> np.ndarray:
        """Append docs given as doc-major rows [sum(lens), dim] and per-doc
        counts: encoded on the device with the index's codec, the IVF
        rebuilt on the host, a built reconstruction store extended."""
        lens = np.asarray(lens, np.int64)
        new_ids = np.arange(self.n_docs, self.n_docs + len(lens))
        if len(lens) == 0:
            return new_ids
        a, w = encode(self.codec, flat.to(self.device))
        if self.recon is not None:        # keep a built cache coherent
            self.recon.add_flat(decode(self.codec, a, w), lens)
        self.assignments = torch.cat([self.assignments, a])
        self.codes = torch.cat([self.codes, w])
        self.vec2doc = np.concatenate([self.vec2doc,
                                       np.repeat(new_ids, lens)])
        self.doc_offsets = np.concatenate(
            [self.doc_offsets, self.doc_offsets[-1] + np.cumsum(lens)])
        self.ivf = build_inverted_lists(self.assignments.cpu().numpy(),
                                        self.codec.n_centroids)
        self._invalidate()
        return new_ids

    def delete(self, doc_ids) -> None:
        """Remove docs, compacting: the remaining docs are renumbered in
        order, the reconstruction store is dropped (rebuilt on use)."""
        doc_ids = np.asarray(doc_ids, np.int64)
        keep = ~np.isin(self.vec2doc, doc_ids)
        doc_keep = ~np.isin(np.arange(self.n_docs), doc_ids)
        keep_t = torch.from_numpy(keep).to(self.device)
        self.assignments = self.assignments[keep_t]
        self.codes = self.codes[keep_t]
        new_lens = np.diff(self.doc_offsets)[doc_keep]
        self.doc_offsets = np.zeros(len(new_lens) + 1, np.int64)
        np.cumsum(new_lens, out=self.doc_offsets[1:])
        self.vec2doc = np.repeat(np.arange(len(new_lens)), new_lens)
        self.ivf = build_inverted_lists(self.assignments.cpu().numpy(),
                                        self.codec.n_centroids)
        self.recon = None
        self._invalidate()

    def device_bytes_detail(self) -> dict:
        """Device bytes of the query-time doc representation, by the
        reference's rules: ``packed`` the [n, L] ids (4 B), [n, L, W]
        words (4 B each) and [n, L] mask (1 B) of ``padded_packed``, from
        shapes whether or not the view is built; ``codec`` the centroid,
        cutoff and value tables; ``recon`` the reconstruction store while
        it is built (``DocStore.device_nbytes``: the port counts its flat
        rows too, which live on the card); ``ivf`` the device IVF while
        it is built."""
        n = max(self.n_docs, 1)
        W = self.codes.shape[1]
        return {
            "packed": n * self._padded_len() * (4 + 4 * W + 1),
            "codec": sum(t.numel() * t.element_size()
                         for t in (self.codec.centroids, self.codec.cutoffs,
                                   self.codec.values)),
            "recon": (self.recon.device_nbytes()
                      if self.recon is not None else 0),
            "ivf": (self._device_ivf.device_bytes()
                    if self._device_ivf is not None else 0),
        }

    def device_bytes(self) -> int:
        return sum(self.device_bytes_detail().values())


def build_plaid_index(flat: torch.Tensor, lens: np.ndarray,
                           codec: ResidualCodec,
                           doc_maxlen: int = 256) -> PLAIDIndex:
    """flat [n_vectors, dim] doc-major vectors, lens [n_docs] per-doc
    counts -> index (encode on the vectors' device, IVF on the host)."""
    lens = np.asarray(lens, np.int64)
    a, w = encode(codec, flat)
    doc_offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=doc_offsets[1:])
    return PLAIDIndex(
        codec=codec,
        ivf=build_inverted_lists(a.cpu().numpy(), codec.n_centroids),
        assignments=a, codes=w,
        vec2doc=np.repeat(np.arange(len(lens)), lens),
        doc_offsets=doc_offsets, doc_maxlen=doc_maxlen)


# ---------------------------------------------------------------------------
# Batched search stages
# ---------------------------------------------------------------------------
def _pad_up(n: int, mult: int) -> int:
    return max(((n + mult - 1) // mult) * mult, mult)


def _ladder(n: int) -> int:
    """The ``pad_candidate_sets`` geometric width for a max count n."""
    n = max(int(n), 1)
    return _CAND_BLOCK << max(int(np.ceil(np.log2(-(-n // _CAND_BLOCK)))), 0)


def _floor_ladder(n: int) -> int:
    """Largest geometric width <= n (0 if n < the smallest width)."""
    if n < _CAND_BLOCK:
        return 0
    C = _CAND_BLOCK
    while C * 2 <= n:
        C *= 2
    return C


def _centroid_scores_batch(qs: torch.Tensor,
                           centroids: torch.Tensor) -> torch.Tensor:
    """Stage 1: qs [Nq, Lq, dim] -> centroid scores [Nq, Lq, K]."""
    return torch.einsum("qld,kd->qlk", qs.float(), centroids.float())


def device_probe_plan(index: PLAIDIndex, Lq: int, nprobe: int, ndocs: int,
                      probe_kernel: str = "auto"):
    """``(use_device, (div, k, c_score, s_out))`` — the reference's plan:
    the device path is taken only on an exact IVF view (``overflow ==
    0``), when the dense corpus-wide dispatch is unreachable for every
    possible candidate count and, under ``"auto"``, ``doc_member`` is
    under the gather cap; ``"host"`` always refuses it. ``c_score`` is
    the static stage-2/3 width, ``s_out`` the rerank slate width."""
    if probe_kernel not in PROBE_KERNELS:
        raise ValueError(f"probe_kernel must be one of {PROBE_KERNELS}, "
                         f"got {probe_kernel!r}")
    if probe_kernel == "host" or index.n_vectors == 0 or index.n_docs == 0:
        return False, None
    div = index.device_ivf()
    if div.overflow != 0:
        return False, None
    n_docs = index.n_docs
    k = min(nprobe, index.codec.n_centroids)
    W = max(Lq, 1) * k * div.list_cap
    c_score = _pad_up(min(W, n_docs), _CAND_BLOCK)
    s_out = min(c_score, _pad_up(int(ndocs), _CAND_BLOCK))
    lmax = _ladder(min(W, n_docs))
    f_prune = _pad_up(int(ndocs), _CAND_BLOCK) if lmax > ndocs else 0
    f_noprune = min(lmax, _floor_ladder(int(ndocs)))
    if max(f_prune, f_noprune) >= n_docs:
        return False, None
    if (probe_kernel != "device"
            and div.doc_member.numel() > _DEVICE_GATHER_CAP):
        return False, None
    return True, (div, k, c_score, s_out)


def probe_members(cs, qm, doc_member, live, k: int):
    """Stages 1-2 on the device: stable top-k probes per valid query
    token (masked-token probes dropped), then the candidate set of every
    query as one matmul of its probed-centroid row with ``doc_member``.
    -> (member [Nq, n_docs] bool, counts [Nq])."""
    Nq = cs.shape[0]
    csm = cs.masked_fill(~qm[:, :, None], float("-inf"))
    _, probe = stable_topk(csm, k)                          # [Nq, Lq, k]
    flat = probe.reshape(Nq, -1)
    pvalid = qm[:, :, None].expand(probe.shape).reshape(Nq, -1)
    K = doc_member.shape[0]
    probed = ((flat[:, :, None] == torch.arange(K, device=cs.device))
              & pvalid[:, :, None]).any(dim=1)              # [Nq, K]
    hits = probed.float() @ doc_member                      # [Nq, n_docs]
    member = (hits > 0.0) & live[None, :]
    return member, member.sum(dim=1)


def _device_candidates(cs, qs, qm, doc_member, live, codes, tok_mask,
                       centroids, *, k: int, t_cs: float, ndocs: int,
                       c_score: int, s_out: int, impl: str):
    """Stages 1-3 on the device -> (cand [Nq, s_out] int64, mask).

    Same slates as the reference (ids, validity and slot order):
    ``probe_members``, then ascending compaction by cumulative
    positions, then the reference's prune decision (padded gather width
    > ndocs, read on the host) and the approximate-score prune."""
    Nq = cs.shape[0]
    n_docs = live.shape[0]
    dev = cs.device
    with record_function("search.probe_members"):
        member, counts = probe_members(cs, qm, doc_member, live, k)
        pos = torch.cumsum(member, dim=1) - 1
        tpos = torch.where(member, pos, torch.full_like(pos, c_score))
        docid = torch.arange(n_docs, device=dev).expand(Nq, n_docs)
        cand_c = torch.zeros((Nq, c_score + 1), dtype=torch.long,
                             device=dev)
        cand_c.scatter_(1, tpos, docid)                     # c_score: dropped
        cand_c = cand_c[:, :c_score]
        mask_c = torch.arange(c_score, device=dev)[None, :] < counts[:, None]

    maxc = max(int(counts.max()), 1)                        # host sync
    if _ladder(maxc) <= ndocs:
        return cand_c[:, :s_out], mask_c[:, :s_out]
    keep = min(ndocs, c_score)
    with record_function("search.code_gather"):
        gcodes = codes[cand_c]                              # [Nq, C, L]
        gmask = tok_mask[cand_c] & mask_c[:, :, None]
    with record_function("search.plaid_probe"):
        approx = plaid_probe_scores(qs, qm, centroids, gcodes, gmask, mask_c,
                                    t_cs=t_cs, impl=impl)
    with record_function("search.prune"):
        top_s, top_i = stable_topk(approx, keep)
        cand_p = torch.gather(cand_c, 1, top_i)
        mask_p = torch.isfinite(top_s)
        if keep < s_out:
            cand_p = torch.nn.functional.pad(cand_p, (0, s_out - keep))
            mask_p = torch.nn.functional.pad(mask_p, (0, s_out - keep))
    return cand_p, mask_p


def _gather_candidates(index: PLAIDIndex, probe: np.ndarray,
                       live: Optional[np.ndarray], probe_valid: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Host stage 2: probe [Nq, Lq, k] centroid ids -> padded candidate
    doc ids [Nq, C] + validity [Nq, C], sorted unique ids per query.
    ``probe_valid`` drops masked-token probes (a top-k over an all--inf
    row would otherwise walk centroids 0..k-1)."""
    Nq = probe.shape[0]
    K = index.ivf.n_centroids
    flat = probe.reshape(Nq, -1).astype(np.int64)
    keys = (np.arange(Nq)[:, None] * K + flat)[probe_valid.reshape(Nq, -1)]
    qc = np.unique(keys)                 # each probed list walked once
    qi, ci = qc // K, qc % K
    starts = index.ivf.offsets[ci]
    lens = index.ivf.offsets[ci + 1] - starts
    if int(lens.sum()) == 0:
        return np.zeros((Nq, 1), np.int64), np.zeros((Nq, 1), bool)
    pos = np.repeat(starts, lens) + ragged_arange(lens)
    docs = index.vec2doc[index.ivf.ids[pos]]
    qidx = np.repeat(qi, lens)
    qd = np.unique(qidx * np.int64(index.n_docs) + docs)
    qidx, docs = qd // index.n_docs, qd % index.n_docs
    if live is not None:
        keep = live[docs]
        qidx, docs = qidx[keep], docs[keep]
    return pad_candidate_sets(qidx, docs, Nq, block=_CAND_BLOCK)


def _host_candidates(index: PLAIDIndex, cs, qs, qm, live, *, k: int,
                     t_cs: float, ndocs: int, impl: str):
    """Stages 1-3 on the host path -> (cand [Nq, S] int64, mask) on the
    index's device: numpy list walk, then, where the padded slate is
    wider than ``ndocs``, the ``plaid_probe`` prune to the best
    ``ndocs`` (block-padded), ordered by approximate score."""
    dev = index.device
    _, probe = stable_topk(cs.masked_fill(~qm[:, :, None], float("-inf")),
                           k)                               # [Nq, Lq, k]
    probe_valid = qm[:, :, None].expand(probe.shape).cpu().numpy()
    cand, cmask = _gather_candidates(index, probe.cpu().numpy(), live,
                                     probe_valid)
    cand = torch.from_numpy(cand).to(dev)
    cmask = torch.from_numpy(cmask).to(dev)
    if cand.shape[1] <= ndocs:
        return cand, cmask
    codes, tok_mask = index.padded_codes()
    approx = plaid_probe_scores(
        qs, qm, index.codec.centroids.contiguous(), codes[cand],
        tok_mask[cand] & cmask[:, :, None], cmask, t_cs=t_cs, impl=impl)
    keep = min(ndocs, cand.shape[1])
    top_s, top_i = stable_topk(approx, keep)
    cand = torch.gather(cand, 1, top_i)
    cmask = torch.isfinite(top_s)
    S = _pad_up(keep, _CAND_BLOCK)
    if S > keep:
        cand = torch.nn.functional.pad(cand, (0, S - keep))
        cmask = torch.nn.functional.pad(cmask, (0, S - keep))
    return cand, cmask


def plaid_candidates(index: PLAIDIndex, qs: torch.Tensor, nprobe: int = 8,
                     t_cs: float = 0.3, ndocs: int = 8192, live=None,
                     q_mask: Optional[torch.Tensor] = None,
                     probe_kernel: str = "auto", impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 1-3 for a query batch: qs [Nq, Lq, dim] -> survivor doc ids
    [Nq, S] + validity [Nq, S], on the index's device. Masked query
    tokens contribute nothing to probes or approximate scores. ``live``
    ([n_docs] bool, numpy or tensor) drops dead docs. ``probe_kernel``
    picks the device path (where ``device_probe_plan`` allows it) or the
    host path; both give the same slates."""
    dev = index.device
    qs = qs.float().to(dev).contiguous()
    Nq, Lq = qs.shape[:2]
    if index.n_vectors == 0:
        return (torch.zeros((Nq, 1), dtype=torch.long, device=dev),
                torch.zeros((Nq, 1), dtype=torch.bool, device=dev))
    use_device, geom = device_probe_plan(index, Lq, nprobe, ndocs,
                                         probe_kernel)
    qm = (torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
          if q_mask is None else q_mask.to(dev, torch.bool).contiguous())
    with record_function("search.centroid_scores"):
        cs = _centroid_scores_batch(qs, index.codec.centroids)
    if not use_device:
        if isinstance(live, torch.Tensor):
            live = live.cpu().numpy()
        return _host_candidates(index, cs, qs, qm, live,
                                k=min(nprobe, index.codec.n_centroids),
                                t_cs=float(t_cs), ndocs=int(ndocs),
                                impl=impl)
    div, k, c_score, s_out = geom
    if live is None:
        live = torch.ones(index.n_docs, dtype=torch.bool, device=dev)
    live = torch.as_tensor(live, device=dev)
    codes, tok_mask = index.padded_codes()
    return _device_candidates(
        cs, qs, qm, div.doc_member, live, codes, tok_mask,
        index.codec.centroids.contiguous(), k=k, t_cs=float(t_cs),
        ndocs=int(ndocs), c_score=c_score, s_out=s_out, impl=impl)


def maxsim_packed_rerank_store(index: PLAIDIndex, q: torch.Tensor,
                               q_mask: torch.Tensor, cand: torch.Tensor,
                               cand_mask: torch.Tensor, *, slab: int = 1024,
                               impl: str = "auto") -> torch.Tensor:
    """Stage 4 from packed codes, slabbed over the candidate axis:
    cand/cand_mask [Nq, C] -> scores [Nq, C] (-inf invalid)."""
    codec = index.codec
    ids, words, tmask = index.padded_packed()
    q = q.float().contiguous()
    q_mask = q_mask.contiguous()
    centroids = codec.centroids.float().contiguous()
    values = codec.values.float().contiguous()
    parts = []
    for lo in range(0, cand.shape[1], slab):
        c = cand[:, lo:lo + slab]
        cm = cand_mask[:, lo:lo + slab]
        with record_function("search.packed_gather"):
            dm = tmask[c] & cm[:, :, None]
            w, a = words[c], ids[c]
        with record_function("search.maxsim_packed"):
            s = maxsim_packed_rerank(q, q_mask, w, a, dm, centroids, values,
                                     bits=codec.bits, impl=impl)
            parts.append(s.masked_fill(~cm, float("-inf")))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def plaid_search_batch(index: PLAIDIndex, qs, k: int = 10, nprobe: int = 8,
                       t_cs: float = 0.3, ndocs: int = 8192,
                       probe_kernel: str = "auto"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The batch API: qs [Nq, Lq, dim] -> host (scores [Nq, k], ids
    [Nq, k]), padded with -inf / -1: stages 1-3 (``plaid_candidates``),
    the packed rerank and one top-k."""
    qs = torch.as_tensor(qs).float().to(index.device)
    Nq = qs.shape[0]
    if index.n_vectors == 0:
        return (np.full((Nq, k), -np.inf, np.float32),
                np.full((Nq, k), -1, np.int64))
    cand, cmask = plaid_candidates(index, qs, nprobe=nprobe, t_cs=t_cs,
                                   ndocs=ndocs, probe_kernel=probe_kernel)
    qm = torch.ones(qs.shape[:2], dtype=torch.bool, device=index.device)
    scores = maxsim_packed_rerank_store(index, qs, qm, cand, cmask)
    return topk_with_pads(scores, cand, k)


def plaid_search(index: PLAIDIndex, q, k: int = 10, nprobe: int = 8,
                 t_cs: float = 0.3, ndocs: int = 8192,
                 probe_kernel: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
    """One query: q [Lq, dim] -> (scores [<= k], doc ids [<= k]), best
    first."""
    S, I = plaid_search_batch(index, torch.as_tensor(q)[None], k=k,
                              nprobe=nprobe, t_cs=t_cs, ndocs=ndocs,
                              probe_kernel=probe_kernel)
    valid = I[0] >= 0
    return S[0][valid], I[0][valid]
