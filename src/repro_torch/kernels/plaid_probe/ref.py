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
