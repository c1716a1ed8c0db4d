"""PLAID-style staged late-interaction search (Santhanam et al., 2022).

Counterpart of ``src/repro/core/plaid.py`` for the device-resident path:

  1. centroid probe — every query token scores all K centroids
     (``_centroid_scores_batch``), top-``nprobe`` ids per token;
  2. candidate generation — probed-centroid rows times the 0/1
     ``doc_member`` table give each query's candidate docs, compacted
     ascending (``_device_candidates``);
  3. approximate scoring and prune — when the candidate ladder exceeds
     ``ndocs``, the ``plaid_probe`` kernel scores candidates from their
     centroid ids alone and the best ``ndocs`` survive;
  4. exact rerank from packed codes — the ``maxsim_packed`` kernel
     (``maxsim_packed_rerank_store``).

The reference's host probe path and its dense corpus-wide fallback are
not ported: where ``device_probe_plan`` refuses the device path, search
raises ``NotImplementedError`` (ROADMAP queue 1, persistence and the
host probe path). Index arrays the search reads live on the index's
device; the IVF bookkeeping is host numpy, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.docstore import ragged_arange
from repro_torch.core.ivf import (DeviceInvertedLists, InvertedLists,
                                  build_device_inverted_lists,
                                  build_inverted_lists)
from repro_torch.core.maxsim import stable_topk
from repro_torch.core.quantization import ResidualCodec, encode
from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores

_CAND_BLOCK = 32       # candidate-axis padding granularity
_DEVICE_GATHER_CAP = 1 << 24   # doc_member elements the device path takes
_UNPORTED = ("host probe path / dense fallback: not ported yet (ROADMAP "
             "queue 1, persistence with the host probe path and the "
             "maxsim all-pairs kernel)")


@dataclass
class PLAIDIndex:
    codec: ResidualCodec
    ivf: InvertedLists
    assignments: torch.Tensor    # [n_vectors] int32 centroid ids (device)
    codes: torch.Tensor          # [n_vectors, W] int32 packed words (device)
    vec2doc: np.ndarray          # [n_vectors] int64 doc id (host)
    doc_offsets: np.ndarray      # [n_docs + 1] int64 (host)
    doc_maxlen: int
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
                lens = np.diff(self.doc_offsets)
                kept = np.minimum(lens, L)
                rows = np.repeat(np.arange(n), kept)
                cols = ragged_arange(kept)
                src = np.repeat(self.doc_offsets[:-1], kept) + cols
                r, c, s = (torch.from_numpy(a).to(dev)
                           for a in (rows, cols, src))
                ids[r, c] = self.assignments[s]
                words[r, c] = self.codes[s]
                mask[r, c] = True
            self._packed_padded = (ids, words, mask)
        return self._packed_padded

    def padded_codes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, _, mask = self.padded_packed()
        return ids, mask

    def device_ivf(self) -> DeviceInvertedLists:
        """Cached exact device IVF."""
        if self._device_ivf is None:
            self._device_ivf = build_device_inverted_lists(
                self.ivf, self.vec2doc, self.n_docs, self.device)
        return self._device_ivf

    def device_bytes(self) -> int:
        total = sum(t.numel() * t.element_size()
                    for t in (self.codec.centroids, self.codec.cutoffs,
                              self.codec.values))
        if self._packed_padded is not None:
            total += sum(t.numel() * t.element_size()
                         for t in self._packed_padded)
        if self._device_ivf is not None:
            total += self._device_ivf.device_bytes()
        return total


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


def device_probe_plan(index: PLAIDIndex, Lq: int, nprobe: int, ndocs: int):
    """``(use_device, (div, k, c_score, s_out))`` — the reference's plan
    (``probe_kernel="auto"``; the port's IVF view is always exact): the
    device path is taken only when the dense corpus-wide dispatch is
    unreachable for every possible candidate count and ``doc_member`` is
    under the gather cap. ``c_score`` is the static stage-2/3 width, ``s_out`` the
    rerank slate width."""
    if index.n_vectors == 0 or index.n_docs == 0:
        return False, None
    div = index.device_ivf()
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
    if div.doc_member.numel() > _DEVICE_GATHER_CAP:
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
    member, counts = probe_members(cs, qm, doc_member, live, k)
    pos = torch.cumsum(member, dim=1) - 1
    tpos = torch.where(member, pos, torch.full_like(pos, c_score))
    docid = torch.arange(n_docs, device=dev).expand(Nq, n_docs)
    cand_c = torch.zeros((Nq, c_score + 1), dtype=torch.long, device=dev)
    cand_c.scatter_(1, tpos, docid)                         # c_score: dropped
    cand_c = cand_c[:, :c_score]
    mask_c = torch.arange(c_score, device=dev)[None, :] < counts[:, None]

    maxc = max(int(counts.max()), 1)                        # host sync
    if _ladder(maxc) <= ndocs:
        return cand_c[:, :s_out], mask_c[:, :s_out]
    keep = min(ndocs, c_score)
    gcodes = codes[cand_c]                                  # [Nq, C, L]
    gmask = tok_mask[cand_c] & mask_c[:, :, None]
    approx = plaid_probe_scores(qs, qm, centroids, gcodes, gmask, mask_c,
                                t_cs=t_cs, impl=impl)
    top_s, top_i = stable_topk(approx, keep)
    cand_p = torch.gather(cand_c, 1, top_i)
    mask_p = torch.isfinite(top_s)
    if keep < s_out:
        cand_p = torch.nn.functional.pad(cand_p, (0, s_out - keep))
        mask_p = torch.nn.functional.pad(mask_p, (0, s_out - keep))
    return cand_p, mask_p


def plaid_candidates(index: PLAIDIndex, qs: torch.Tensor, nprobe: int = 8,
                     t_cs: float = 0.3, ndocs: int = 8192,
                     live: Optional[torch.Tensor] = None,
                     q_mask: Optional[torch.Tensor] = None,
                     impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 1-3 for a query batch: qs [Nq, Lq, dim] -> survivor doc ids
    [Nq, S] + validity [Nq, S], on the index's device. Masked query
    tokens contribute nothing to probes or approximate scores."""
    qs = qs.float()
    Nq, Lq = qs.shape[:2]
    use_device, geom = device_probe_plan(index, Lq, nprobe, ndocs)
    if not use_device:
        raise NotImplementedError(_UNPORTED)
    div, k, c_score, s_out = geom
    dev = index.device
    qm = (torch.ones((Nq, Lq), dtype=torch.bool, device=dev)
          if q_mask is None else q_mask.to(dev, torch.bool))
    if live is None:
        live = torch.ones(index.n_docs, dtype=torch.bool, device=dev)
    cs = _centroid_scores_batch(qs, index.codec.centroids)
    codes, tok_mask = index.padded_codes()
    return _device_candidates(
        cs, qs.contiguous(), qm.contiguous(), div.doc_member, live, codes,
        tok_mask, index.codec.centroids.contiguous(), k=k, t_cs=float(t_cs),
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
        dm = tmask[c] & cm[:, :, None]
        s = maxsim_packed_rerank(q, q_mask, words[c], ids[c], dm, centroids,
                                 values, bits=codec.bits, impl=impl)
        parts.append(s.masked_fill(~cm, float("-inf")))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
