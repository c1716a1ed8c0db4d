"""Roofline terms for the device-resident PLAID candidate pipeline
(``src/repro/roofline/probe.py``).

The fused probe kernel (``kernels/plaid_probe``) plus the device IVF
gather (``core/ivf.py``) replace the host candidate generator: stage 1's
centroid scores stay on device, stage 2 becomes a fixed-shape
padded-list gather + sort-based dedupe, and stage 3 re-derives each
candidate token's centroid score on the device instead of a
host-orchestrated gather. What the host path paid in PCIe hops (probe
ids down, candidate ids back up) the device path pays in decode work;
this module prices that trade with the three-term model of
``roofline/analysis.py`` on the H100 of ``roofline/hw.py``, with every
count the reference's:

    python -m repro_torch.roofline.run --kernel plaid_probe --json out.json

FLOPs are analytic. ``onehot_decode_flops`` prices the TPU kernel's
one-hot matmul (2 C L K Lq a query); the CUDA kernel
(``csrc/plaid_probe.cu``) builds each query's centroid-score table once
and looks the candidates' codes up in it, so the card's own bound for it
stays ``chip_smoke.py``'s ``_probe_bound``. Sort cost is the
bitonic-network bound of the reference's model. ``PCIE_GBPS`` and
``HOST_SORT_KEYS_PER_S`` are the reference's modelling constants, not
measurements of the H100's host.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.roofline.analysis import RooflineTerms

# representative serving cell: 8 queries x 32 tokens probing nprobe=8 of
# 2^12 centroids whose unique-doc lists pad to 256; candidates padded to
# 4096 docs of 64 pooled tokens at the paper's dim=128
DEFAULT_SHAPE = dict(nq=8, lq=32, k_centroids=4096, nprobe=8, lmax=256,
                     c=4096, ld=64, dim=128)

# effective per-direction host<->device bandwidth for the hop pricing
# (PCIe gen4 x16 less protocol overhead — the transfers are small, so
# latency-bound in practice; this is deliberately optimistic for host)
PCIE_GBPS = 20.0
# effective np.unique throughput on the (query, doc) key sweep — int64
# comparison sort with cache-missing gathers; measured on the serving
# host class, single core (the probe pool parallelizes across shards,
# not within one)
HOST_SORT_KEYS_PER_S = 5e7


def probe_flops(nq, lq, k_centroids, dim) -> float:
    """Stage 1: q [nq, lq, dim] @ centroids^T [dim, K]."""
    return 2.0 * nq * lq * k_centroids * dim


def gather_bytes(nq, lq, nprobe, lmax) -> int:
    """Stage 2 device gather: padded doc-list rows + validity."""
    return nq * lq * nprobe * lmax * (4 + 1)


def dedupe_flops(nq, lq, nprobe, lmax) -> float:
    """Two bitonic sorts over the W padded slots per query
    (~W log^2 W compare-exchange each)."""
    w = max(lq * nprobe * lmax, 2)
    lg = math.log2(w)
    return 2.0 * nq * w * lg * lg


def onehot_decode_flops(nq, c, ld, k_centroids, lq) -> float:
    """Stage 3 in-kernel: one-hot [C*L, K] @ csp^T [K, Lq] per query —
    the MXU-shaped substitute for the host vmap gather."""
    return 2.0 * nq * c * ld * k_centroids * lq


def reduce_flops(nq, c, ld, lq) -> float:
    """Masked max over doc tokens + sum over query tokens + top-k."""
    return 2.0 * nq * c * ld * lq


def device_stream_bytes(nq, lq, k_centroids, nprobe, lmax, c, ld,
                        dim) -> int:
    """HBM traffic of the fused pipeline: queries + centroid table in,
    gathered lists + candidate code rows streamed, slate out."""
    return (nq * lq * (dim * 4 + 1)            # queries + mask
            + k_centroids * dim * 4            # centroid table
            + gather_bytes(nq, lq, nprobe, lmax)
            + nq * c * ld * (4 + 1)            # candidate code rows + mask
            + nq * c * (4 + 1))                # slate ids + validity out


def host_hop_bytes(nq, lq, nprobe, c) -> int:
    """PCIe bytes the host path moves per batch: probe ids D2H, then the
    deduped candidate matrix H2D (int64 + bool, ``pad_candidate_sets``)."""
    return nq * lq * nprobe * 4 + nq * c * (8 + 1)


def plaid_probe_report(shape: Optional[Dict[str, int]] = None) -> Dict:
    """Roofline rows for the device pipeline vs the host-hop baseline."""
    sh = dict(DEFAULT_SHAPE)
    if shape:
        sh.update(shape)
    nq, lq, kc = sh["nq"], sh["lq"], sh["k_centroids"]
    nprobe, lmax, c, ld, dim = (sh["nprobe"], sh["lmax"], sh["c"],
                                sh["ld"], sh["dim"])

    rows: List[Dict] = []
    # host baseline: device matmuls (stage 1 + stage 3 vmap gather view)
    # plus the two PCIe hops and a host-side sort the device never pays
    h_fl = {
        "probe": probe_flops(nq, lq, kc, dim),
        "approx_gather": reduce_flops(nq, c, ld, lq),
        "reduce": reduce_flops(nq, c, ld, lq),
    }
    h_bytes = (nq * lq * (dim * 4 + 1) + kc * dim * 4
               + nq * c * ld * (4 + 1) + nq * c * (4 + 1))
    hop = host_hop_bytes(nq, lq, nprobe, c)
    h_terms = RooflineTerms(
        arch="plaid_probe_host", cell="host_gather", mesh="1chip",
        flops=sum(h_fl.values()), hlo_bytes=float(h_bytes),
        collective_bytes=0.0)
    hop_s = hop / (PCIE_GBPS * 1e9)
    # the host work the device path deletes: np.unique over every
    # (query, doc) key the walked lists produce, serialized with the
    # device (the gather can't start until the probe ids land on host)
    sort_s = (nq * lq * nprobe * lmax) / HOST_SORT_KEYS_PER_S
    host_side_s = hop_s + sort_s
    rows.append({
        "kernel": "plaid_probe_host", "flop_terms": h_fl,
        "flops": sum(h_fl.values()), "stream_bytes": h_bytes,
        "host_hop_bytes": hop, "host_hop_s": hop_s,
        "host_sort_s": sort_s,
        "compute_s": h_terms.compute_s, "memory_s": h_terms.memory_s,
        "total_s": max(h_terms.compute_s, h_terms.memory_s) + host_side_s,
        "bottleneck": "host" if host_side_s > max(h_terms.compute_s,
                                                  h_terms.memory_s)
        else h_terms.bottleneck,
        "terms": h_terms,
    })
    d_fl = {
        "probe": probe_flops(nq, lq, kc, dim),
        "dedupe_sort": dedupe_flops(nq, lq, nprobe, lmax),
        "onehot_decode": onehot_decode_flops(nq, c, ld, kc, lq),
        "reduce": reduce_flops(nq, c, ld, lq),
    }
    d_bytes = device_stream_bytes(nq, lq, kc, nprobe, lmax, c, ld, dim)
    d_terms = RooflineTerms(
        arch="plaid_probe_dev", cell="fused_kernel", mesh="1chip",
        flops=sum(d_fl.values()), hlo_bytes=float(d_bytes),
        collective_bytes=0.0)
    rows.append({
        "kernel": "plaid_probe_dev", "flop_terms": d_fl,
        "flops": sum(d_fl.values()), "stream_bytes": d_bytes,
        "host_hop_bytes": 0, "host_hop_s": 0.0,
        "compute_s": d_terms.compute_s, "memory_s": d_terms.memory_s,
        "total_s": max(d_terms.compute_s, d_terms.memory_s),
        "bottleneck": d_terms.bottleneck,
        "terms": d_terms,
    })
    rows[1]["speedup_vs_host"] = (rows[0]["total_s"]
                                  / max(rows[1]["total_s"], 1e-30))
    return {"shape": sh, "rows": rows}
