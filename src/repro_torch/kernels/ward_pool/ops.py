"""Wrapper of the Ward pooling kernel (``csrc/ward_pool.cu``).

Same contract as ``src/repro/kernels/ward_pool/ops.py`` ``ward_assign``:
the wrapper normalizes the token vectors as the reference does, computes
each document's merge budget, and launches one block per document. CPU
tensors (or ``impl="ref"``) run the plain version; CUDA tensors launch
the kernel on the current stream or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ward import normalize_masked, ward_targets
from repro_torch.kernels import (LaunchCounter, build, check_cuda,
                                 check_dtype, check_impl)
from repro_torch.kernels.ward_pool.ref import ward_assign_ref

LAUNCHES = LaunchCounter()
_NAME = "ward_pool"
_SMEM_LIMIT = 232448
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ward_pool_launch.argtypes = [P] * 4 + [I] * 3 + [P]
        lib.ward_pool_launch.restype = I
        lib.ward_pool_smem_bytes.argtypes = [I, I]
        lib.ward_pool_smem_bytes.restype = ctypes.c_size_t
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
    xu = normalize_masked(x, mask).contiguous()
    mask = mask.contiguous()
    _, steps = ward_targets(mask, int(factor))
    check_cuda(_NAME, x=xu, mask=mask, steps=steps)
    lib = _load()
    if lib.ward_pool_smem_bytes(N, d) > _SMEM_LIMIT:
        raise ValueError(f"{_NAME}: N={N}, d={d} exceed shared memory")
    out = torch.empty((B, N), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.ward_pool_launch(xu.data_ptr(), mask.data_ptr(),
                                steps.data_ptr(), out.data_ptr(), B, N, d,
                                stream)
    build.check(code, _NAME)
    LAUNCHES.count += 1
    return out
