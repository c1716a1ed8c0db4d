"""Roofline shares of the program's kernels: the benchmark's own counts.

A kernel's share is its bound time over its measured device time (the
traced run's device seconds by kernel name). The bound time is the
larger of its operations over the peaks and its bytes over the HBM
rate. The counts follow what the inputs of each call need, whatever
implements the kernel:

* every product once, at the TF32 tensor-core peak (the fastest rate
  at f32-grade accuracy); other arithmetic at the f32 peak;
* each input byte read once and each output byte written once;
* data-dependent work (valid tokens, the slate) from the call's inputs.

The implementation's passes (3xTF32's three) and re-reads are never
counted. ``Capture`` wraps the program's kernel entry points during the
traced window and keeps each call's counts as device scalars, so that
counting makes the host wait for nothing; ``totals`` sums them after the
window.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, dense peaks from the data sheet (700 W)
HBM_BW = 3.35e12            # bytes/s
PEAK_TF32 = 494.7e12        # FLOP/s, tensor cores
PEAK_F32 = 67e12            # FLOP/s, outside the tensor cores
PEAK_BF16 = 989e12          # FLOP/s, tensor cores

# device-kernel names of each entry point, as the trace shows them
KERNEL_NAMES = {"ward_pool": ("ward_pool_kernel",),
                "plaid_probe": ("plaid_table_kernel", "plaid_probe_kernel"),
                "maxsim_packed": ("maxsim_packed_kernel",)}


def bound_s(products: float, other_ops: float, n_bytes: float) -> float:
    return max(products / PEAK_TF32 + other_ops / PEAK_F32, n_bytes / HBM_BW)


def ward_pool_counts(x, mask, factor: int):
    """Ward to ``n // factor + 1`` clusters of each document: the Gram
    products of its n valid unit vectors (n (n - 1) / 2 pairs of d),
    ~12 n operations a merge (an argmin over a row and the
    Lance-Williams update); x [B, N, d] f32 read, mask read, the
    [B, N] int32 assignment written."""
    B, N, d = x.shape
    n = mask.sum(1).long()
    merges = (n - (n // factor + 1)).clamp(min=0)
    return ((n * (n - 1)).sum() * d, (merges * n).sum() * 12,
            B * N * d * 4 + B * N + B * N * 4)


def plaid_probe_counts(q, q_mask, centroids, codes, code_mask, cand_mask):
    """Approximate scores of a candidate slate: each query's [Lq, K]
    centroid table (valid query tokens), then per valid candidate token
    and valid query token a lookup and a max (2 operations); reads the
    queries, centroids, the slot flags and the codes and flags of valid
    slots, writes [Nq, C] f32."""
    Nq, Lq, dim = q.shape
    K = centroids.shape[0]
    L = codes.shape[2]
    lq = q_mask.sum(1)
    toks = (code_mask & cand_mask[:, :, None]).sum((1, 2))
    slots = cand_mask.sum()
    products = lq.sum() * K * dim * 2
    other = (toks * lq).sum() * 2
    n_bytes = (Nq * Lq * (dim * 4 + 1) + K * dim * 4 + cand_mask.numel()
               + slots * L * 5 + Nq * codes.shape[1] * 4)
    return products, other, n_bytes


def maxsim_packed_counts(q, q_mask, words, ids, doc_mask, centroids, values):
    """Exact MaxSim from packed codes: per valid doc token its
    reconstruction (centroid + value per dimension, renormalised: 4
    operations a dimension), per valid (query token, doc token) pair a
    product of dim and a max; reads the queries, the masks, the codec
    and the words and ids of valid tokens, writes [Nq, S] f32."""
    Nq, Lq, dim = q.shape
    S = words.shape[1]
    W = words.shape[3]
    lq = q_mask.sum(1)
    tok = doc_mask.sum((1, 2))
    pairs = (lq * tok).sum()
    products = pairs * dim * 2
    other = tok.sum() * dim * 4 + pairs
    n_bytes = (Nq * Lq * (dim * 4 + 1) + doc_mask.numel()
               + centroids.numel() * 4 + values.numel() * 4
               + tok.sum() * (4 * W + 4) + Nq * S * 4)
    return products, other, n_bytes


class Capture:
    """Wraps the program's three kernel entry points for the traced
    window: each call adds its counts (device scalars) and goes on to
    the program's function."""

    def __init__(self):
        self.calls: Dict[str, list] = {k: [] for k in KERNEL_NAMES}
        self._undo = []

    def _wrap(self, module, attr: str, name: str, count):
        inner = getattr(module, attr)
        calls = self.calls[name]

        def wrapped(*args, **kw):
            calls.append(count(*args, **kw))
            return inner(*args, **kw)

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, inner))

    def __enter__(self):
        import repro_torch.core.plaid as plaid
        import repro_torch.kernels.ward_pool.ops as ward_ops
        self._wrap(ward_ops, "ward_assign", "ward_pool",
                   lambda x, mask, factor, **kw: ward_pool_counts(
                       x, mask, factor))
        self._wrap(plaid, "plaid_probe_scores", "plaid_probe",
                   lambda q, qm, c, codes, cm, cand, **kw:
                   plaid_probe_counts(q, qm, c, codes, cm, cand))
        self._wrap(plaid, "maxsim_packed_rerank", "maxsim_packed",
                   lambda q, qm, w, a, dm, c, v, **kw:
                   maxsim_packed_counts(q, qm, w, a, dm, c, v))
        return self

    def __exit__(self, *exc):
        for module, attr, inner in reversed(self._undo):
            setattr(module, attr, inner)
        self._undo.clear()

    def totals(self) -> Dict[str, tuple]:
        """kernel -> (calls, products, other operations, bytes)."""
        out = {}
        for name, calls in self.calls.items():
            if calls:
                p, o, b = (float(sum(float(c[i]) for c in calls))
                           for i in range(3))
                out[name] = (len(calls), p, o, b)
        return out


def share(ctx: dict, kernel: str):
    """Percent of the bound in the traced window, or None where the
    kernel did not run."""
    from bench.trace import kernel_seconds
    tot = ctx.get("counts", {}).get(kernel)
    measured = kernel_seconds(ctx.get("kernel_s", {}), *KERNEL_NAMES[kernel])
    if not tot or measured <= 0:
        return None
    _, products, other, n_bytes = tot
    return 100.0 * bound_s(products, other, n_bytes) / measured


def encoder_flops(model: dict, n_tokens) -> float:
    """Forward FLOPs of the encoder over sequences of ``n_tokens``
    positions each (an iterable of ints): the products of the
    projections, the MLP, the two attention products and the final
    projection, 2 operations a multiply-add."""
    d, ff, L = model["d_model"], model["d_ff"], model["n_layers"]
    lin = 4 * d * d + 2 * d * ff
    total = 0
    for n in n_tokens:
        n = int(n)
        total += L * (2 * n * lin + 4 * n * n * d) + 2 * n * d * model[
            "proj_dim"]
    return float(total)
