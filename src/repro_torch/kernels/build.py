"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so one source compiles in seconds. It is compiled at first use into
``build/kernels/lib<name>-<hash>.so`` under the repository root (the
hash covers the source and the shared headers, so an edited source never
loads a stale library) and opened once per process.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception. Nothing here runs at import.
``library_events()`` counts the libraries compiled or opened so far in
this process (the serving engine's ``CompileCounter`` reads it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("ward_pool", "plaid_probe", "maxsim_packed", "maxsim",
           "kmeans_assign", "dequant_score", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_events = [0]          # libraries compiled or opened in this process


def library_events() -> int:
    """Libraries compiled (``nvcc`` runs) or opened (``ctypes``) so far."""
    return _events[0]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, final) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    _events[0] += 1
    return log


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named kernels, one ``nvcc`` per source, all started
    together. Returns each compiler log (ptxas register/smem report);
    an already-built library gives an empty log."""
    names = list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
                _events[0] += 1
    return lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {code}")
