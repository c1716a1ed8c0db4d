"""Wrapper of the compressed-domain rerank kernel (``csrc/maxsim_packed.cu``).

Same argument layout as ``src/repro/kernels/maxsim_packed/ops.py``
``maxsim_packed_rerank``. CPU tensors (or ``impl="ref"``) run the plain
version; CUDA tensors launch the kernel on the current stream or raise.
A launch takes at most ``MAX_LQ`` query tokens; longer queries are split
into chunks, one launch each, and the partial scores summed. The chunk is
the widest of ``CHUNK_WIDTHS`` whose shared memory fits beside the
candidates' token list (which grows with Ld): at dim 128 and 4 bits,
128 query tokens a launch up to Ld 509, 96 up to 2,685, 64 up to 4,861,
32 up to 7,037 (2 bits: 1,149, 3,325, 5,501, 7,677).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LaunchCounter, build, check_cuda,
                                 check_dtype, check_impl,
                                 sum_over_query_chunks)
from repro_torch.kernels.maxsim_packed.ref import maxsim_packed_rerank_ref

LAUNCHES = LaunchCounter()
_NAME = "maxsim_packed"
_SMEM_LIMIT = 232448
MAX_LQ = 128        # query tokens a launch (csrc: 32 * MAX_QCH)
# query tokens a launch, widest first: the query rows take most of a
# block's shared memory, so a long document narrows the chunk
CHUNK_WIDTHS = (MAX_LQ, 96, 64, 32)
MAX_DIM = 128       # token width the kernel takes, a multiple of 8
MAX_LD = 8191       # doc tokens a candidate (csrc: CPB * Ld < 65536)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.maxsim_packed_launch.argtypes = [P] * 8 + [I] * 7 + [P]
        lib.maxsim_packed_launch.restype = I
        lib.maxsim_packed_smem_bytes.argtypes = [I, I, I, I]
        lib.maxsim_packed_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def maxsim_packed_rerank(q, q_mask, words, ids, d_mask, centroids, values,
                         *, bits: int, impl: str = "auto"):
    """q [Nq, Lq, dim] f32; q_mask [Nq, Lq] bool; words [Nq, S, Ld, W]
    int32 (uint32 bits); ids [Nq, S, Ld] int32; d_mask [Nq, S, Ld] bool;
    centroids [K, dim] f32; values [dim, 2^bits] f32 -> scores [Nq, S]
    f32 (0 where a candidate has no valid token)."""
    check_impl(impl)
    if impl == "ref" or q.device.type == "cpu":
        return maxsim_packed_rerank_ref(q, q_mask, words, ids, d_mask,
                                        centroids, values, bits=bits)
    if q.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {q.device}")
    for key, t, dt in (("q", q, torch.float32), ("q_mask", q_mask, torch.bool),
                       ("words", words, torch.int32), ("ids", ids, torch.int32),
                       ("d_mask", d_mask, torch.bool),
                       ("centroids", centroids, torch.float32),
                       ("values", values, torch.float32)):
        check_dtype(_NAME, key, t, dt)
    check_cuda(_NAME, q=q, q_mask=q_mask, words=words, ids=ids,
               d_mask=d_mask, centroids=centroids, values=values)
    if bits not in (2, 4):
        raise ValueError(f"{_NAME}: bits must be 2 or 4, got {bits}")
    Nq, Lq, dim = q.shape
    _, S, Ld, W = words.shape
    if (words.shape[0] != Nq or tuple(ids.shape) != (Nq, S, Ld)
            or tuple(d_mask.shape) != (Nq, S, Ld)
            or tuple(q_mask.shape) != (Nq, Lq)
            or centroids.shape[1] != dim
            or tuple(values.shape) != (dim, 1 << bits)
            or W * 32 != dim * bits):
        raise ValueError(f"{_NAME}: inconsistent shapes q {tuple(q.shape)} "
                         f"words {tuple(words.shape)} ids {tuple(ids.shape)} "
                         f"centroids {tuple(centroids.shape)} "
                         f"values {tuple(values.shape)}")
    if dim > MAX_DIM or dim % 8 or Ld > MAX_LD:
        raise ValueError(f"{_NAME}: dim={dim} (at most {MAX_DIM}, a multiple"
                         f" of 8) or Ld={Ld} (at most {MAX_LD}) not taken")
    lib = _load()
    # the widest query chunk whose shared memory fits: at Lq <= 128 and
    # short documents one launch on the tensors as given
    fits = [w for w in CHUNK_WIDTHS
            if lib.maxsim_packed_smem_bytes(min(Lq, w), dim, bits, Ld)
            <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"{_NAME}: dim={dim}, Ld={Ld} exceed shared memory "
                         f"at {CHUNK_WIDTHS[-1]} query tokens a launch")
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch(qc, qmc):
        out = torch.empty((Nq, S), dtype=torch.float32, device=q.device)
        code = lib.maxsim_packed_launch(
            qc.data_ptr(), qmc.data_ptr(), words.data_ptr(), ids.data_ptr(),
            d_mask.data_ptr(), centroids.data_ptr(), values.data_ptr(),
            out.data_ptr(), Nq, qc.shape[1], dim, S, Ld, W, bits, stream)
        build.check(code, _NAME)
        LAUNCHES.bump()
        return out

    return sum_over_query_chunks(launch, q, q_mask, fits[0])
