"""Rules of the port (``src/repro_torch``):

* no module imports ``jax`` or the JAX package ``repro`` (checked in a
  fresh interpreter, so nothing imported by the tests leaks in);
* entry points given no device run on ``cuda`` and raise without one —
  they never fall back to the CPU quietly;
* CPU tensors run the kernels' plain versions (no launch is counted);
* where the reference would take the host probe path or the dense
  fallback, the port raises ``NotImplementedError`` instead.
"""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.colbertv2 import SMOKE
from repro_torch.core.index import MultiVectorIndex
from repro_torch.core.spec import IndexSpec
from repro_torch.kernels import launch_counts

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _modules()
    assert "repro_torch.kernels.ward_pool.ops" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_without_device_need_cuda(monkeypatch):
    import repro_torch as rt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.init_colbert(SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiVectorIndex(dim=8)
    model = rt.init_colbert(SMOKE, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.Indexer(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiVectorIndex(dim=8, device="cuda")
    assert rt.resolve_device("cpu").type == "cpu"


def _index(n_docs, **kw):
    rng = np.random.default_rng(0)
    docs = []
    for _ in range(n_docs):
        v = rng.normal(size=(int(rng.integers(2, 6)), 16)).astype(np.float32)
        docs.append(torch.from_numpy(v / np.linalg.norm(v, axis=-1,
                                                        keepdims=True)))
    idx = MultiVectorIndex(dim=16, device="cpu", doc_maxlen=24,
                           n_centroids=16, **kw)
    idx.add(docs)
    return idx, rng


def test_cpu_search_runs_plain_versions():
    idx, rng = _index(200, nprobe=2, ndocs=16)
    before = launch_counts()
    qs = torch.from_numpy(rng.normal(size=(3, 4, 16)).astype(np.float32))
    S, I = idx.search_batch(qs, k=5)
    S1, I1 = idx.search_batch(qs, k=5, impl="ref")
    np.testing.assert_array_equal(I, I1)
    np.testing.assert_array_equal(S, S1)
    assert (I >= 0).all()
    assert launch_counts() == before
    with pytest.raises(ValueError):
        idx.search_batch(qs, k=5, impl="kernel")


def test_refused_device_plan_raises_not_implemented():
    # 40 docs under the default ndocs: the reference would go to the
    # host probe path and the dense corpus-wide rerank
    idx, rng = _index(40)
    qs = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idx.search_batch(qs, k=5)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        IndexSpec(backend="flat")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiVectorIndex(dim=8, backend="hnsw", device="cpu")
    with pytest.raises(ValueError):
        IndexSpec(quant_bits=3)
    idx, _ = _index(5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idx.add([torch.zeros(2, 16)])
