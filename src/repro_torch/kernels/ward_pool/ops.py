"""Wrapper of the Ward pooling kernel (``csrc/ward_pool.cu``).

Same contract as ``src/repro/kernels/ward_pool/ops.py`` ``ward_assign``:
the wrapper normalizes the token vectors as the reference does and
launches one block per document, which computes the norms, Gram matrix
and distances of its unit vectors and derives its merge budget from its
mask as ``ward_targets`` does. The kernel keeps a document's distance
triangle in shared memory up to 330 tokens; above that the wrapper gives
it a [B, N(N-1)/2] scratch in device memory. CPU tensors (or
``impl="ref"``) run the plain version; CUDA tensors launch the kernel on
the current stream or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ward import normalize_masked
from repro_torch.kernels import (LaunchCounter, build, check_cuda,
                                 check_dtype, check_impl)
from repro_torch.kernels.ward_pool.ref import ward_assign_ref

LAUNCHES = LaunchCounter()
_NAME = "ward_pool"
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ward_pool_launch.argtypes = [P, P, I, P, P, I, I, I, P]
        lib.ward_pool_launch.restype = I
        lib.ward_pool_scratch_floats.argtypes = [I]
        lib.ward_pool_scratch_floats.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def ward_assign(x, mask, factor: int, *, impl: str = "auto"):
    """x [B, N, d] float; mask [B, N] bool -> assign [B, N] int32, each
    valid token's cluster representative (lowest token index)."""
    check_impl(impl)
    if impl == "ref" or x.device.type == "cpu":
        return ward_assign_ref(x, mask, factor)
    if x.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x.device}")
    check_dtype(_NAME, "mask", mask, torch.bool)
    B, N, d = x.shape
    if tuple(mask.shape) != (B, N):
        raise ValueError(f"{_NAME}: mask {tuple(mask.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if int(factor) < 1:
        raise ValueError(f"{_NAME}: factor must be >= 1, got {factor}")
    if N * N >= 2 ** 31 or d < 1:
        raise ValueError(f"{_NAME}: N={N}, d={d} not taken by the kernel")
    xu = normalize_masked(x, mask).contiguous()
    mask = mask.contiguous()
    check_cuda(_NAME, x=xu, mask=mask)
    lib = _load()
    per_doc = lib.ward_pool_scratch_floats(N)
    scratch = (torch.empty((B, per_doc), dtype=torch.float32,
                           device=x.device) if per_doc else None)
    out = torch.empty((B, N), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.ward_pool_launch(
        xu.data_ptr(), mask.data_ptr(), int(factor),
        scratch.data_ptr() if per_doc else None, out.data_ptr(), B, N, d,
        stream)
    build.check(code, _NAME)
    LAUNCHES.bump()
    return out
