"""Wrapper of the k-means assignment kernel (``csrc/kmeans_assign.cu``).

Same contract as ``src/repro/kernels/kmeans_assign/ops.py``
``kmeans_assign`` for x [N, dim] against centroids [K, dim], and batched
over documents (x [B, N, dim], centroids [B, K, dim], k_mask [B, K]),
which per-document k-means pooling needs: one launch per Lloyd step for
a whole encode batch. x and the centroids may be f32 or bf16; both are
read as f32, as the reference kernel casts them, and the token width is
zero-padded to a multiple of 8 where it is not one. CPU tensors (or
``impl="ref"``) run the plain version; CUDA tensors launch the kernel on
the current stream or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import (LaunchCounter, build, check_cuda, check_dtype,
                                 check_impl, check_inputs, plain_version)
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

LAUNCHES = LaunchCounter()
_NAME = "kmeans_assign"
_SMEM_LIMIT = 232448
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.kmeans_assign_launch.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.kmeans_assign_launch.restype = I
        lib.kmeans_assign_smem_bytes.argtypes = [I]
        lib.kmeans_assign_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor,
                  k_mask: Optional[torch.Tensor] = None, *,
                  impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, dim] or [B, N, dim]; centroids [K, dim] or [B, K, dim];
    k_mask [K] or [B, K] bool (None: all valid) -> (assign int32,
    best f32), each [N] or [B, N]."""
    check_impl(impl)
    check_inputs(_NAME, x, centroids, k_mask)
    single = x.dim() == 2
    if single:
        x, centroids = x[None], centroids[None]
        k_mask = None if k_mask is None else k_mask[None]
    B, N, dim = x.shape
    K = centroids.shape[1]
    if k_mask is None:
        k_mask = torch.ones((B, K), dtype=torch.bool, device=x.device)
    if (centroids.dim() != 3 or tuple(centroids.shape) != (B, K, dim)
            or tuple(k_mask.shape) != (B, K)):
        raise ValueError(f"{_NAME}: inconsistent shapes x {tuple(x.shape)} "
                         f"centroids {tuple(centroids.shape)} "
                         f"k_mask {tuple(k_mask.shape)}")
    if plain_version(impl, x):
        a, s = kmeans_assign_ref(x, centroids, k_mask)
    else:
        a, s = _launch(x, centroids, k_mask)
    return (a[0], s[0]) if single else (a, s)


def _aligned(t):
    """f32, contiguous, the last axis zero-padded to a multiple of 8 (the
    mma's k-step; zeros add nothing to a dot product) and 16-byte aligned
    (the kernel's 16-byte copies)."""
    t = t.float().contiguous()
    pad = -t.shape[-1] % 8
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, centroids, k_mask):
    if x.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {x.device}")
    for key, t in (("x", x), ("centroids", centroids)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{_NAME}: {key} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    check_dtype(_NAME, "k_mask", k_mask, torch.bool)
    x, centroids = _aligned(x), _aligned(centroids)
    k_mask = k_mask.contiguous()
    check_cuda(_NAME, x=x, centroids=centroids, k_mask=k_mask)
    B, N, dim = x.shape
    K = centroids.shape[1]
    lib = _load()
    if lib.kmeans_assign_smem_bytes(dim) > _SMEM_LIMIT:
        raise ValueError(f"{_NAME}: dim={dim} exceeds shared memory")
    assign = torch.empty((B, N), dtype=torch.int32, device=x.device)
    best = torch.empty((B, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.kmeans_assign_launch(x.data_ptr(), centroids.data_ptr(),
                                    k_mask.data_ptr(), assign.data_ptr(),
                                    best.data_ptr(), B, N, K, dim, stream)
    build.check(code, _NAME)
    LAUNCHES.bump()
    return assign, best
