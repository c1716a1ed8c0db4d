"""Roofline terms for the compressed-domain rerank kernel
(``src/repro/roofline/packed.py``).

The fused packed kernel (``kernels/maxsim_packed``) streams the PACKED
doc representation, a 4-byte centroid id, W uint32 residual words and a
1-byte mask per token, instead of the f32 reconstruction the legacy
rerank stage read (dim*4 + 1 bytes per token). Per-chip HBM traffic for
the doc operand drops by ~(dim*4) / (4 + 4*W); the decode work moves
on-chip.

This module prices both paths with the three-term model of
``roofline/analysis.py`` on the H100 of ``roofline/hw.py``, with every
count the reference's:

    python -m repro_torch.roofline.run --kernel packed_rerank --json out.json

FLOPs are analytic. ``decode`` prices the TPU kernel's one-hot gather
matmul (2 M K dim); the CUDA kernel (``csrc/maxsim_packed.cu``) gathers
each token's centroid row instead and runs its products as 3xTF32, so
the card's own bound for it stays ``chip_smoke.py``'s ``_packed_bound``
(bytes, or the products' 3 TF32 passes and the f32 reconstruction). A
``torch.utils.flop_counter`` count of the port's plain version at a tiny
shape is recorded per row as a cross-check (``plain_ref_flops_small``,
the reference's ``xla_ref_flops_small``), never substituted.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.roofline.analysis import RooflineTerms

# representative serving slab: 8 queries x 1024 rerank candidates of 64
# pooled doc tokens at the paper's dim=128 / 2^12-centroid codec
DEFAULT_SHAPE = dict(nq=8, lq=32, s=1024, ld=64, dim=128, k_centroids=4096)


def words_per_token(dim: int, bits: int) -> int:
    """uint32 residual words per doc token (32/bits codes per word)."""
    lanes = 32 // bits
    return (dim + lanes - 1) // lanes


def packed_doc_bytes_per_token(dim: int, bits: int) -> int:
    """id (int32) + packed residual words + mask byte — the per-token
    HBM cost of the compressed-domain doc operand (plaid
    ``device_bytes_detail()['packed']`` uses the same formula)."""
    return 4 + 4 * words_per_token(dim, bits) + 1


def recon_doc_bytes_per_token(dim: int) -> int:
    """f32 vector + mask byte — what the reconstruction store streamed."""
    return dim * 4 + 1


def _common_bytes(nq, lq, s, ld, dim) -> int:
    """Operands both paths stream identically: queries + query mask in,
    score slab out."""
    return nq * lq * (dim * 4 + 1) + nq * s * 4


def packed_stream_bytes(nq, lq, s, ld, dim, k_centroids, bits) -> int:
    codec = k_centroids * dim * 4 + dim * (1 << bits) * 4
    return (nq * s * ld * packed_doc_bytes_per_token(dim, bits)
            + codec + _common_bytes(nq, lq, s, ld, dim))


def recon_stream_bytes(nq, lq, s, ld, dim) -> int:
    return (nq * s * ld * recon_doc_bytes_per_token(dim)
            + _common_bytes(nq, lq, s, ld, dim))


def packed_flops(nq, lq, s, ld, dim, k_centroids, bits) -> Dict[str, float]:
    """Analytic flop terms of the fused kernel body.

    decode   one-hot gather matmul [M, K] @ [K, dim], M = nq*s*ld
    unpack   where-chain over 2^bits value planes + shift/mask ops
    renorm   square, sum, rsqrt, scale over [M, dim]
    maxsim   the scoring matmul [lq, dim] @ [dim, M] per query
    reduce   masked max over doc tokens + sum over query tokens
    """
    m = nq * s * ld
    return {
        "decode": 2.0 * m * k_centroids * dim,
        "unpack": float((1 << bits) + 3) * m * dim,
        "renorm": 4.0 * m * dim,
        "maxsim": 2.0 * nq * lq * s * ld * dim,
        "reduce": 2.0 * nq * lq * s * ld,
    }


def recon_flops(nq, lq, s, ld, dim) -> Dict[str, float]:
    """The legacy path's query-time flops: decode happened at build time
    (that is exactly the trade — HBM bytes for on-chip decode work)."""
    return {
        "maxsim": 2.0 * nq * lq * s * ld * dim,
        "reduce": 2.0 * nq * lq * s * ld,
    }


def _plain_ref_flops(nq, lq, s, ld, dim, bits) -> Optional[float]:
    """``FlopCounterMode``'s count of the port's plain version
    (``maxsim_packed_rerank`` on CPU tensors) at this shape: a
    cross-check of the op accounting; None where it counts nothing."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
    w = words_per_token(dim, bits)
    args = (torch.zeros((nq, lq, dim)), torch.ones((nq, lq), dtype=torch.bool),
            torch.zeros((nq, s, ld, w), dtype=torch.int32),
            torch.zeros((nq, s, ld), dtype=torch.int32),
            torch.ones((nq, s, ld), dtype=torch.bool),
            torch.zeros((16, dim)), torch.zeros((dim, 1 << bits)))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        maxsim_packed_rerank(*args, bits=bits)
    f = float(counter.get_total_flops())
    return f if f > 0 else None


def packed_rerank_report(shape: Optional[Dict[str, int]] = None,
                         bits_list=(2, 4),
                         cross_check: bool = True) -> Dict:
    """Roofline rows for the packed kernel at each codec width plus the
    reconstruction-path baseline it replaced."""
    sh = dict(DEFAULT_SHAPE)
    if shape:
        sh.update(shape)
    nq, lq, s, ld = sh["nq"], sh["lq"], sh["s"], sh["ld"]
    dim, kc = sh["dim"], sh["k_centroids"]

    rows: List[Dict] = []
    r_bytes = recon_stream_bytes(nq, lq, s, ld, dim)
    r_fl = recon_flops(nq, lq, s, ld, dim)
    recon_terms = RooflineTerms(
        arch="maxsim_recon", cell="f32_store", mesh="1chip",
        flops=sum(r_fl.values()), hlo_bytes=float(r_bytes),
        collective_bytes=0.0)
    rows.append({
        "kernel": "maxsim_recon", "bits": None,
        "doc_bytes_per_token": recon_doc_bytes_per_token(dim),
        "stream_bytes": r_bytes, "flop_terms": r_fl,
        "flops": sum(r_fl.values()),
        "compute_s": recon_terms.compute_s,
        "memory_s": recon_terms.memory_s,
        "bottleneck": recon_terms.bottleneck,
        "bytes_ratio_vs_recon": 1.0,
        "terms": recon_terms,
    })
    for bits in bits_list:
        b = packed_stream_bytes(nq, lq, s, ld, dim, kc, bits)
        fl = packed_flops(nq, lq, s, ld, dim, kc, bits)
        terms = RooflineTerms(
            arch="maxsim_packed", cell=f"bits={bits}", mesh="1chip",
            flops=sum(fl.values()), hlo_bytes=float(b),
            collective_bytes=0.0)
        row = {
            "kernel": "maxsim_packed", "bits": bits,
            "doc_bytes_per_token": packed_doc_bytes_per_token(dim, bits),
            "stream_bytes": b, "flop_terms": fl,
            "flops": sum(fl.values()),
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "bottleneck": terms.bottleneck,
            "bytes_ratio_vs_recon": r_bytes / b,
            "doc_bytes_ratio_vs_recon": (recon_doc_bytes_per_token(dim)
                                         / packed_doc_bytes_per_token(
                                             dim, bits)),
            "terms": terms,
        }
        if cross_check:
            # tiny shape: the cross-check pins op accounting, not scale
            row["plain_ref_flops_small"] = _plain_ref_flops(
                2, 4, 8, 6, dim, bits)
        rows.append(row)
    return {"shape": sh, "rows": rows}
