"""Wrapper of the fused dequantize + score kernel (``csrc/dequant_score.cu``).

Same signature as ``src/repro/kernels/quant/ops.py`` ``dequant_score``:
packed words [M, W] (int32 carrying the uint32 bits), centroid ids [M],
the codec's centroids [K, dim] and bucket values [dim, 2^bits], query
tokens q [Lq, dim] -> sims [M, Lq] f32. The kernel reads each row's
centroid itself (the JAX wrapper gathers the rows first). CPU tensors
(or ``impl="ref"``) run the plain version; CUDA tensors launch the
kernel on the current stream or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LaunchCounter, build, check_cuda,
                                 check_dtype, check_impl)
from repro_torch.kernels.quant.ref import dequant_score_ref

LAUNCHES = LaunchCounter()
_NAME = "dequant_score"
_SMEM_LIMIT = 232448
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dequant_score_launch.argtypes = [P] * 6 + [I] * 5 + [P]
        lib.dequant_score_launch.restype = I
        lib.dequant_score_smem_bytes.argtypes = [I, I, I]
        lib.dequant_score_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def dequant_score(words, centroid_ids, centroids, values, q, *,
                  bits: int = 2, impl: str = "auto"):
    """words [M, W] int32; centroid_ids [M] int32; centroids [K, dim] f32;
    values [dim, 2^bits] f32; q [Lq, dim] f32 -> sims [M, Lq] f32."""
    check_impl(impl)
    if impl == "ref" or words.device.type == "cpu":
        return dequant_score_ref(words, centroid_ids, centroids, values, q,
                                 bits)
    if words.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {words.device}")
    for key, t, dt in (("words", words, torch.int32),
                       ("centroid_ids", centroid_ids, torch.int32),
                       ("centroids", centroids, torch.float32),
                       ("values", values, torch.float32),
                       ("q", q, torch.float32)):
        check_dtype(_NAME, key, t, dt)
    check_cuda(_NAME, words=words, centroid_ids=centroid_ids,
               centroids=centroids, values=values, q=q)
    if bits not in (2, 4):
        raise ValueError(f"{_NAME}: bits must be 2 or 4, got {bits}")
    M, W = words.shape
    Lq, dim = q.shape
    if (tuple(centroid_ids.shape) != (M,) or centroids.shape[1] != dim
            or tuple(values.shape) != (dim, 1 << bits)
            or W * 32 != dim * bits):
        raise ValueError(f"{_NAME}: inconsistent shapes words "
                         f"{tuple(words.shape)} centroid_ids "
                         f"{tuple(centroid_ids.shape)} centroids "
                         f"{tuple(centroids.shape)} values "
                         f"{tuple(values.shape)} q {tuple(q.shape)}")
    if q.data_ptr() % 16:       # the kernel's 16-byte loads of q
        q = q.clone()
    lib = _load()
    if lib.dequant_score_smem_bytes(Lq, dim, bits) > _SMEM_LIMIT:
        raise ValueError(f"{_NAME}: Lq={Lq}, dim={dim} exceed shared memory")
    out = torch.empty((M, Lq), dtype=torch.float32, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    code = lib.dequant_score_launch(
        words.data_ptr(), centroid_ids.data_ptr(), centroids.data_ptr(),
        values.data_ptr(), q.data_ptr(), out.data_ptr(), M, Lq, dim, W,
        bits, stream)
    build.check(code, _NAME)
    LAUNCHES.bump()
    return out
