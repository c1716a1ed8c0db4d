"""Wrappers of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention_bh`` takes the TPU kernel's layout
(``src/repro/kernels/flash_attention/kernel.py`` ``flash_attention_pallas``):
q [B*H, Sq, dh], k and v [B*KV, Skv, dh]. ``flash_attention`` takes
[B, H, S, dh] and [B, KV, S, dh], as ``src/repro/kernels/flash_attention/
ops.py`` ``flash_attention`` does; any Sq and Skv (the kernel masks the
tails, so the reference wrapper's block-size fitting is not needed).

The kernel reads each tensor through its own batch, head and row strides
(unit stride along dh, 16-byte aligned), so the model's [B, S, H, dh]
projections go in as transposed views without a copy, and
``flash_attention`` writes its output in [B, S, H, dh] memory (returned
as the [B, H, S, dh] view), the layout the output projection reads.

bf16 or f32 in (q, k and v of one dtype), output in q's dtype, dh 64,
112 (Kimi K2's width) or 128. bf16 runs on the tensor cores
(``mma.sync``), with an instance at each of the three widths; f32 runs
the f32 FMA body, which keeps the f32 contract, at 64 or 128: an f32 dh
of 112 is zero-padded to 128 here (the padded columns add 0 to q k^T;
their output columns are cut off). The softmax scale passed to the
kernel is f32(1/sqrt(dh)) of the true dh either way. CPU tensors (or
``impl="ref"``) run the plain version; CUDA tensors launch the kernel on
the current stream or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import (LaunchCounter, build, check_impl,
                                 check_inputs, plain_version)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LAUNCHES = LaunchCounter()
_NAME = "flash_attention"
HEAD_DIMS = (64, 112, 128)
# f32 dh the f32 body does not take -> the width it is zero-padded to
_F32_PADDED = {112: 128}
_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = ([P] * 4 + [I] * 6 + [P]
                                               + [I] * 2
                                               + [ctypes.c_float, P])
        lib.flash_attention_launch.restype = I
        _lib = lib
    return _lib


def _check_shapes(q, k, v, n_dim):
    if q.dim() != n_dim or k.dim() != n_dim or v.shape != k.shape:
        raise ValueError(f"{_NAME}: expected q, k, v of {n_dim} dims with "
                         f"k and v alike, got q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    heads, kv_heads = q.shape[-3], k.shape[-3]
    if (k.shape[-1] != q.shape[-1] or kv_heads == 0 or heads % kv_heads
            or q.shape[:-3] != k.shape[:-3]):
        raise ValueError(f"{_NAME}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (one batch, heads "
                         f"a multiple of kv heads, one dh)")


def _strides(name, t):
    """(batch, head, row) strides of a [B, H, S, dh] tensor, in elements;
    raises unless dh has unit stride and rows are 16-byte aligned."""
    if t.stride(3) != 1:
        raise ValueError(f"{_NAME}: {name} must have unit stride along dh")
    # a dimension of size 1 is never stepped along: its stride is moot
    st = [t.stride(d) if t.shape[d] > 1 else 0 for d in range(3)]
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in st):
        raise ValueError(f"{_NAME}: {name} and its strides must be 16-byte "
                         f"aligned")
    return st


def _launch(q, k, v, o, causal):
    """q, o [B, H, Sq, dh]; k, v [B, KV, Skv, dh], all on one CUDA device."""
    if len({t.device for t in (q, k, v, o)}) != 1:
        raise ValueError(f"{_NAME}: tensors on several devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{_NAME}: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head dim {dh} not in {HEAD_DIMS}")
    scale = 1.0 / math.sqrt(dh)             # the true dh's, padded or not
    if q.dtype == torch.float32 and dh in _F32_PADDED:
        pad = _F32_PADDED[dh] - dh
        o_pad = torch.empty((B, H, Sq, dh + pad), dtype=q.dtype,
                            device=q.device)
        _run(*(F.pad(t, (0, pad)) for t in (q, k, v)), o_pad, causal, scale)
        o.copy_(o_pad[..., :dh])
        return
    _run(q, k, v, o, causal, scale)


def _run(q, k, v, o, causal, scale):
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*(
        s for name, t in (("q", q), ("k", k), ("v", v), ("o", o))
        for s in _strides(name, t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV, Sq,
        Skv, dh, strides, int(causal), int(q.dtype == torch.bfloat16),
        scale, stream)
    build.check(code, _NAME)
    LAUNCHES.bump()


def _on_card(q, impl):
    check_impl(impl)
    if plain_version(impl, q):
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {q.device}")
    return True


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True,
                       impl: str = "auto") -> torch.Tensor:
    """q [BH, Sq, dh]; k, v [BKV, Skv, dh] -> o [BH, Sq, dh] (contiguous)
    in q's dtype."""
    check_inputs(_NAME, q, k, v)
    _check_shapes(q, k, v, 3)
    if not _on_card(q, impl):
        return flash_attention_ref(q, k, v, causal=causal)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q[None], k[None], v[None], o[None], causal)
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """q [B, H, Sq, dh]; k, v [B, KV, Skv, dh] (H % KV == 0), any strides
    with unit stride along dh -> o [B, H, Sq, dh], a view of [B, Sq, H, dh]
    memory on the card."""
    check_inputs(_NAME, q, k, v)
    _check_shapes(q, k, v, 4)
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if not _on_card(q, impl):
        return flash_attention_ref(
            q.reshape(B * H, Sq, dh), k.reshape(B * KV, Skv, dh),
            v.reshape(B * KV, Skv, dh), causal=causal).reshape(B, H, Sq, dh)
    o = torch.empty((B, Sq, H, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    _launch(q, k, v, o, causal)
    return o
