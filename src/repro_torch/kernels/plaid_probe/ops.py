"""Wrapper of the fused probe kernel (``csrc/plaid_probe.cu``).

Same argument layout as ``src/repro/kernels/plaid_probe/ops.py``
``plaid_probe_scores``. CPU tensors (or ``impl="ref"``) run the plain
version; CUDA tensors launch the kernel on the current stream or raise;
``impl="kernel"`` launches it or raises.
A launch takes at most ``MAX_LQ`` query tokens; longer queries are split
into chunks, one launch each, and the partial scores summed. A launch
runs two kernels (the [Lq, K] table once per query into a scratch, then
the probe), and the counter counts both. ``probe_route`` picks how the
probe reads the table: staged in shared memory where it fits there
(K <= 1,668 at Lq <= 32, K <= 415 at Lq 97-128, dim 128), else read in
the scratch through L2, so every K is served. Narrower query chunks
would also fit the table in shared memory, but on the card they were
slower than the device-memory table at every K measured (``PERF.md``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LaunchCounter, build, check_cuda, check_dtype,
                                 check_impl, check_inputs, plain_version,
                                 sum_over_query_chunks)
from repro_torch.kernels.plaid_probe.ref import plaid_probe_ref

LAUNCHES = LaunchCounter()
PROBE_IMPLS = ("auto", "kernel", "ref")
_NAME = "plaid_probe"
_SMEM_LIMIT = 232448
MAX_LQ = 128                # query tokens a launch (csrc: 32 * MAX_R)
ROUTES = ("smem", "global")
KERNELS_A_LAUNCH = 2        # the table kernel, then the probe kernel
_lib = None


def probe_route(Lq: int, K: int, dim: int, smem_bytes) -> str:
    """``"smem"`` where the table of a launch of min(Lq, ``MAX_LQ``)
    query tokens against K centroids of width dim fits shared memory,
    else ``"global"`` (the table read from device memory).
    ``smem_bytes(lq, K, dim)`` is the kernel's own query
    (``plaid_probe_smem_bytes``)."""
    fits = smem_bytes(min(Lq, MAX_LQ), K, dim) <= _SMEM_LIMIT
    return "smem" if fits else "global"


def _load():
    global _lib
    if _lib is None:
        lib = build.load(_NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.plaid_probe_launch.argtypes = ([P] * 8 + [I] * 6
                                           + [ctypes.c_float, I, P])
        lib.plaid_probe_launch.restype = I
        lib.plaid_probe_smem_bytes.argtypes = [I, I, I]
        lib.plaid_probe_smem_bytes.restype = ctypes.c_size_t
        lib.plaid_probe_table_floats.argtypes = [I, I, I]
        lib.plaid_probe_table_floats.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def plaid_probe_scores(q, q_mask, centroids, codes, code_mask, cand_mask, *,
                       t_cs: float, impl: str = "auto", route=None,
                       chunk: int = MAX_LQ):
    """q [Nq, Lq, dim] f32; q_mask [Nq, Lq] bool; centroids [K, dim] f32;
    codes [Nq, C, L] int32 centroid ids; code_mask [Nq, C, L] bool;
    cand_mask [Nq, C] bool -> approx scores [Nq, C] f32 (-inf invalid).
    ``route`` overrides ``probe_route``'s choice and ``chunk`` the query
    tokens a launch (at most ``MAX_LQ``), to time one against another.
    ``impl`` is one of ``PROBE_IMPLS``: ``"kernel"`` launches as
    ``"auto"`` does on the card and raises on any other device."""
    check_impl(impl, PROBE_IMPLS)
    check_inputs(_NAME, q, q_mask, centroids, codes, code_mask, cand_mask)
    if plain_version(impl, q, _NAME):
        return plaid_probe_ref(q, q_mask, centroids, codes, code_mask,
                               cand_mask, t_cs=t_cs)
    if q.device.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {q.device}")
    for key, t, dt in (("q", q, torch.float32), ("q_mask", q_mask, torch.bool),
                       ("centroids", centroids, torch.float32),
                       ("codes", codes, torch.int32),
                       ("code_mask", code_mask, torch.bool),
                       ("cand_mask", cand_mask, torch.bool)):
        check_dtype(_NAME, key, t, dt)
    check_cuda(_NAME, q=q, q_mask=q_mask, centroids=centroids, codes=codes,
               code_mask=code_mask, cand_mask=cand_mask)
    Nq, Lq, dim = q.shape
    K = centroids.shape[0]
    _, C, L = codes.shape
    if (codes.shape[0] != Nq or tuple(code_mask.shape) != (Nq, C, L)
            or tuple(cand_mask.shape) != (Nq, C)
            or tuple(q_mask.shape) != (Nq, Lq) or centroids.shape[1] != dim):
        raise ValueError(f"{_NAME}: inconsistent shapes q {tuple(q.shape)} "
                         f"centroids {tuple(centroids.shape)} "
                         f"codes {tuple(codes.shape)}")
    for key, t in (("codes", codes), ("code_mask", code_mask)):
        if t.data_ptr() % 16:
            raise ValueError(f"{_NAME}: {key} must be 16-byte aligned "
                             f"(read with 16-byte loads)")
    lib = _load()
    route = route or probe_route(Lq, K, dim, lib.plaid_probe_smem_bytes)
    if route not in ROUTES or not 0 < chunk <= MAX_LQ or (
            route == "smem" and lib.plaid_probe_smem_bytes(
                min(Lq, chunk), K, dim) > _SMEM_LIMIT):
        raise ValueError(f"{_NAME}: route {route!r} at {chunk} query tokens "
                         f"a launch cannot serve Lq={Lq}, K={K}, dim={dim}")
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def launch(qc, qmc):
        out = torch.empty((Nq, C), dtype=torch.float32, device=q.device)
        table = torch.empty(lib.plaid_probe_table_floats(Nq, qc.shape[1], K),
                            dtype=torch.float32, device=q.device)
        code = lib.plaid_probe_launch(
            qc.data_ptr(), qmc.data_ptr(), centroids.data_ptr(),
            codes.data_ptr(), code_mask.data_ptr(), cand_mask.data_ptr(),
            table.data_ptr(), out.data_ptr(), Nq, qc.shape[1], dim, K, C, L,
            float(t_cs), int(route == "global"), stream)
        build.check(code, _NAME)
        LAUNCHES.bump(KERNELS_A_LAUNCH)
        return out

    return sum_over_query_chunks(launch, q, q_mask, chunk)
