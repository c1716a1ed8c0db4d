"""Wrappers of the two MaxSim kernels (``csrc/maxsim.cu``).

``maxsim`` and ``maxsim_rerank`` have the argument layout of
``src/repro/kernels/maxsim/ops.py``'s; ``maxsim_rerank_indexed`` computes
what the JAX package computes by gathering a store's candidates and
calling ``maxsim_rerank``, reading the candidates in place. CPU tensors
(or ``impl="ref"``) run the plain versions; CUDA tensors launch the
kernel on the current stream or raise. The all-pairs entry has its own
launch counter; both rerank entries share ``RERANK_LAUNCHES``. A launch
takes at most ``MAX_LQ`` query tokens; longer queries are split into
chunks of that many, one launch each, and the partial scores summed. A
token width that is not a multiple of 4 (the kernel's 16-byte loads) is
zero-padded to one, queries and documents alike: zeros add nothing to a
dot product. No configuration pays for this copy (every ``proj_dim`` is
a multiple of 32).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LaunchCounter, build, check_cuda, check_dtype,
                                 check_impl, check_inputs, plain_version,
                                 sum_over_query_chunks)
from repro_torch.kernels.maxsim.ref import (maxsim_ref,
                                           maxsim_rerank_indexed_ref,
                                           maxsim_rerank_ref)

LAUNCHES = LaunchCounter()            # maxsim (all-pairs)
RERANK_LAUNCHES = LaunchCounter()     # maxsim_rerank, both layouts
_NAME = "maxsim"
_SMEM_LIMIT = 232448
MAX_LQ = 128        # query tokens a launch (csrc: MAX_QR)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.maxsim_launch, lib.maxsim_rerank_launch):
            fn.argtypes = [P] * 5 + [I] * 5 + [P]
            fn.restype = I
        lib.maxsim_rerank_indexed_launch.argtypes = [P] * 7 + [I] * 6 + [P]
        lib.maxsim_rerank_indexed_launch.restype = I
        lib.maxsim_smem_bytes.argtypes = [I]
        lib.maxsim_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _dim4(t):
    """``t`` with its last axis zero-padded to a multiple of 4 (a fresh,
    aligned tensor), or ``t`` itself where it is one already."""
    pad = -t.shape[-1] % 4
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _checked(name, q, q_mask, d, d_mask, doc_shape):
    """dtype/device/contiguity/shape checks of both entries; -> lib."""
    for key, t, dt in (("q", q, torch.float32), ("q_mask", q_mask, torch.bool),
                       ("d", d, torch.float32), ("d_mask", d_mask, torch.bool)):
        check_dtype(name, key, t, dt)
    check_cuda(name, q=q, q_mask=q_mask, d=d, d_mask=d_mask)
    Nq, Lq, dim = q.shape
    if (tuple(q_mask.shape) != (Nq, Lq) or d.shape[-1] != dim
            or tuple(d.shape[:-2]) != doc_shape
            or tuple(d_mask.shape) != tuple(d.shape[:-1])):
        raise ValueError(f"{name}: inconsistent shapes q {tuple(q.shape)} "
                         f"q_mask {tuple(q_mask.shape)} d {tuple(d.shape)} "
                         f"d_mask {tuple(d_mask.shape)}")
    if dim % 4 or q.data_ptr() % 16 or d.data_ptr() % 16:
        raise ValueError(f"{name}: q, d must be 16-byte aligned with a "
                         f"width that is a multiple of 4 (dim={dim})")
    lib = _load()
    if lib.maxsim_smem_bytes(dim) > _SMEM_LIMIT:
        raise ValueError(f"{name}: dim={dim} exceeds shared memory")
    return lib


def maxsim(q, q_mask, d, d_mask, *, impl: str = "auto"):
    """All-pairs scores: q [Nq, Lq, dim] f32; q_mask [Nq, Lq] bool;
    d [Nd, Ld, dim] f32; d_mask [Nd, Ld] bool -> [Nq, Nd] f32."""
    check_impl(impl)
    check_inputs(_NAME, q, q_mask, d, d_mask)
    if plain_version(impl, q):
        return maxsim_ref(q, q_mask, d, d_mask)
    if q.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {q.device}")
    q, d = _dim4(q), _dim4(d)
    lib = _checked(_NAME, q, q_mask, d, d_mask, (d.shape[0],))
    Nq, _, dim = q.shape
    Nd, Ld, _ = d.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch(qc, qmc):
        out = torch.empty((Nq, Nd), dtype=torch.float32, device=q.device)
        code = lib.maxsim_launch(qc.data_ptr(), qmc.data_ptr(), d.data_ptr(),
                                 d_mask.data_ptr(), out.data_ptr(), Nq,
                                 qc.shape[1], dim, Nd, Ld, stream)
        build.check(code, _NAME)
        LAUNCHES.bump()
        return out

    return sum_over_query_chunks(launch, q, q_mask, MAX_LQ)


def maxsim_rerank(q, q_mask, d, d_mask, *, impl: str = "auto"):
    """Per-query candidate scores: q [Nq, Lq, dim] f32; q_mask [Nq, Lq];
    d [Nq, S, Ld, dim] f32; d_mask [Nq, S, Ld] -> [Nq, S] f32; query i
    scores only d[i]."""
    check_impl(impl)
    check_inputs("maxsim_rerank", q, q_mask, d, d_mask)
    if plain_version(impl, q):
        return maxsim_rerank_ref(q, q_mask, d, d_mask)
    if q.device.type != "cuda":
        raise ValueError(f"maxsim_rerank: unsupported device {q.device}")
    q, d = _dim4(q), _dim4(d)
    lib = _checked("maxsim_rerank", q, q_mask, d, d_mask,
                   (q.shape[0], d.shape[1]))
    Nq, _, dim = q.shape
    _, S, Ld, _ = d.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch(qc, qmc):
        out = torch.empty((Nq, S), dtype=torch.float32, device=q.device)
        code = lib.maxsim_rerank_launch(qc.data_ptr(), qmc.data_ptr(),
                                        d.data_ptr(), d_mask.data_ptr(),
                                        out.data_ptr(), Nq, qc.shape[1], dim,
                                        S, Ld, stream)
        build.check(code, "maxsim_rerank")
        RERANK_LAUNCHES.bump()
        return out

    return sum_over_query_chunks(launch, q, q_mask, MAX_LQ)


def maxsim_rerank_indexed(q, q_mask, d, d_mask, cand, cand_mask, *,
                          impl: str = "auto"):
    """Per-query candidate scores read from a store in place: q
    [Nq, Lq, dim] f32; q_mask [Nq, Lq]; d [Nd, Ld, dim] f32 and d_mask
    [Nd, Ld] (a ``DocStore``'s padded view); cand [Nq, S] integer doc ids;
    cand_mask [Nq, S] bool -> [Nq, S] f32: query i against the documents
    cand[i, s]. An invalid candidate scores 0, and no row of it is read,
    whatever id it holds; a valid one's id must lie in [0, Nd)."""
    check_impl(impl)
    check_inputs("maxsim_rerank_indexed", q, q_mask, d, d_mask, cand,
                  cand_mask)
    if plain_version(impl, q):
        return maxsim_rerank_indexed_ref(q, q_mask, d, d_mask, cand,
                                         cand_mask)
    name = "maxsim_rerank_indexed"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    q, d = _dim4(q), _dim4(d)
    lib = _checked(name, q, q_mask, d, d_mask, (d.shape[0],))
    check_dtype(name, "cand_mask", cand_mask, torch.bool)
    if cand.dtype.is_floating_point or cand.dtype == torch.bool:
        raise TypeError(f"{name}: cand must hold integer ids, got "
                        f"{cand.dtype}")
    cand = cand.to(torch.int64).contiguous()
    check_cuda(name, q=q, cand=cand, cand_mask=cand_mask)
    Nq, _, dim = q.shape
    Nd, Ld, _ = d.shape
    if cand.dim() != 2 or cand.shape[0] != Nq or (
            tuple(cand_mask.shape) != tuple(cand.shape)):
        raise ValueError(f"{name}: cand {tuple(cand.shape)} and cand_mask "
                         f"{tuple(cand_mask.shape)} must both be [{Nq}, S]")
    S = cand.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch(qc, qmc):
        out = torch.empty((Nq, S), dtype=torch.float32, device=q.device)
        code = lib.maxsim_rerank_indexed_launch(
            qc.data_ptr(), qmc.data_ptr(), d.data_ptr(), d_mask.data_ptr(),
            cand.data_ptr(), cand_mask.data_ptr(), out.data_ptr(), Nq,
            qc.shape[1], dim, Nd, S, Ld, stream)
        build.check(code, name)
        RERANK_LAUNCHES.bump()
        return out

    return sum_over_query_chunks(launch, q, q_mask, MAX_LQ)
