"""Plain PyTorch version of the fused probe kernel.

Counterpart of ``src/repro/kernels/plaid_probe/ref.py``: stage 1
(``q . C^T``, masked query tokens to -inf) then the stage-3
centroid-only MaxSim of ``core/plaid.py`` ``_approx_scores_batch``
(t_cs prune, score lookup by code, masked tokens read 0, max over doc
tokens, sum over query tokens, -inf on invalid candidates).
"""
from __future__ import annotations

import torch

_BLOCK = 32       # candidates per lookup pass: bounds [Nq, block, L, Lq]


def plaid_probe_ref(q, q_mask, centroids, codes, code_mask, cand_mask, *,
                    t_cs: float):
    """q [Nq, Lq, dim]; centroids [K, dim]; codes/code_mask [Nq, C, L];
    cand_mask [Nq, C] -> approx scores [Nq, C] f32 (-inf invalid)."""
    cs = torch.einsum("qld,kd->qlk", q.float(), centroids.float())
    cs = cs.masked_fill(~q_mask[:, :, None], float("-inf"))
    csp = torch.where(cs >= t_cs, cs, torch.zeros((), device=cs.device))
    csT = csp.transpose(1, 2)                               # [Nq, K, Lq]
    Nq, C, L = codes.shape
    rows = torch.arange(Nq, device=codes.device)[:, None, None]
    out = []
    for lo in range(0, C, _BLOCK):
        cb = codes[:, lo:lo + _BLOCK].long()                # [Nq, b, L]
        vals = csT[rows, cb]                                # [Nq, b, L, Lq]
        vals = torch.where(code_mask[:, lo:lo + _BLOCK, :, None], vals,
                           torch.zeros((), device=vals.device))
        out.append(vals.amax(dim=2).sum(dim=-1))
    approx = torch.cat(out, dim=1) if out else cs.new_zeros((Nq, 0))
    return approx.masked_fill(~cand_mask, float("-inf"))


def probe_table_ref(q, q_mask, centroids, *, t_cs: float):
    """The kernel's stage-1 table: [Nq, K + 2, Lq] pruned scores (masked
    query tokens -inf, then below t_cs 0), then row K all 0 (what a masked
    candidate token reads) and row K + 1 all -inf (a slot past the last
    token: neutral to the max)."""
    cs = torch.einsum("qld,kd->qkl", q.float(), centroids.float())
    cs = cs.masked_fill(~q_mask[:, None, :], float("-inf"))
    csp = torch.where(cs >= t_cs, cs, torch.zeros((), device=cs.device))
    Nq, _, Lq = csp.shape
    return torch.cat([csp, csp.new_zeros((Nq, 1, Lq)),
                      csp.new_full((Nq, 1, Lq), float("-inf"))], dim=1)


def fold_codes_ref(codes, code_mask, K: int, *, distinct: bool = False):
    """The kernel's table row per candidate token: its code, or K where the
    token is masked. With ``distinct``, a row repeated within a candidate
    is replaced after its first place by K + 1 (the -inf row): the kernel's
    distinct-code lookups, which leave every max unchanged."""
    off = torch.where(code_mask, codes.long(), torch.full_like(codes.long(), K))
    if not distinct:
        return off
    s, order = torch.sort(off, dim=-1, stable=True)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[..., 1:] = s[..., 1:] == s[..., :-1]
    return off.scatter(-1, order, torch.where(dup, K + 1, s))


def plaid_probe_folded_ref(q, q_mask, centroids, codes, code_mask, cand_mask,
                           *, t_cs: float, distinct: bool = False):
    """The kernel's formulation of ``plaid_probe_ref``: the table of
    ``probe_table_ref`` read at ``fold_codes_ref``'s rows, max over the
    candidate's tokens, sum over query tokens, -inf on invalid slots."""
    table = probe_table_ref(q, q_mask, centroids, t_cs=t_cs)
    off = fold_codes_ref(codes, code_mask, centroids.shape[0],
                         distinct=distinct)
    Nq, C, L = codes.shape
    rows = torch.arange(Nq, device=codes.device)[:, None, None]
    out = []
    for lo in range(0, C, _BLOCK):
        vals = table[rows, off[:, lo:lo + _BLOCK]]          # [Nq, b, L, Lq]
        out.append(vals.amax(dim=2).sum(dim=-1))
    approx = torch.cat(out, dim=1) if out else table.new_zeros((Nq, 0))
    return approx.masked_fill(~cand_mask, float("-inf"))
