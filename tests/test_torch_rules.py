"""Rules of the port (``src/repro_torch``):

* no module imports ``jax`` or the JAX package ``repro`` (checked in a
  fresh interpreter, so nothing imported by the tests leaks in);
* entry points given no device run on ``cuda`` and raise without one —
  they never fall back to the CPU quietly;
* CPU tensors run the kernels' plain versions (no launch is counted);
* where the reference takes the host probe path and the dense
  fallback, so does the port, with the reference's results; what is not
  ported yet raises ``NotImplementedError`` naming ROADMAP.
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
from repro_torch.kernels import KERNELS, launch_counts
from repro_torch.kernels.build import SOURCES

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _modules()
    for m in ("kernels.ward_pool.ops", "kernels.maxsim.ops",
              "kernels.maxsim.ref", "core.persist", "core.docstore",
              "kernels.kmeans_assign.ops", "kernels.kmeans_assign.ref",
              "kernels.quant.ops", "core.kmeans", "retrieval.cascade",
              "kernels.flash_attention.ops", "kernels.flash_attention.ref",
              "models.transformer", "models.attention", "launch.steps",
              "configs.qwen3_0_6b", "configs.qwen1_5_0_5b",
              "configs.qwen2_5_14b", "core.sharded", "core.spec", "api"):
        assert f"repro_torch.{m}" in mods
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


def test_seven_kernels_from_six_sources():
    """The seven retrieval kernels keep their launch counters and their
    order in ``KERNELS``, and their six CUDA sources stay in the build."""
    assert KERNELS[:7] == ("ward_pool", "plaid_probe", "maxsim_packed",
                           "maxsim", "maxsim_rerank", "kmeans_assign",
                           "dequant_score")
    assert set(KERNELS[:7]) <= set(launch_counts())
    assert SOURCES[:6] == ("ward_pool", "plaid_probe", "maxsim_packed",
                           "maxsim", "kmeans_assign", "dequant_score")


def test_every_kernel_has_a_counter_and_source():
    """Every ported TPU kernel has a launch counter, and every CUDA
    source under ``csrc/`` is built: eight kernels from seven sources."""
    assert KERNELS == ("ward_pool", "plaid_probe", "maxsim_packed", "maxsim",
                       "maxsim_rerank", "kmeans_assign", "dequant_score",
                       "flash_attention")
    assert set(launch_counts()) == set(KERNELS)
    csrc = os.path.join(SRC, "repro_torch", "csrc")
    assert sorted(SOURCES) == sorted(f[:-3] for f in os.listdir(csrc)
                                     if f.endswith(".cu"))
    assert len(SOURCES) == 7


def test_entry_points_without_device_need_cuda(monkeypatch, tmp_path):
    import repro_torch as rt
    from repro_torch.core.persist import load_sharded
    empty = str(tmp_path / "empty")
    rt.ShardedIndex(dim=8, device="cpu").save(empty)
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
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.CascadeIndex(dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.ShardedIndex(dim=8)
    toks = np.zeros((2, 8), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.Indexer(model).build_streaming(toks, shard_max_vectors=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_sharded(empty)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.load_artifact(empty)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.Retriever.build(model, toks)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.Retriever.load(model, empty)
    assert load_sharded(empty, device="cpu").n_docs == 0
    assert rt.resolve_device("cpu").type == "cpu"


def _docs(n_docs, rng):
    docs = []
    for _ in range(n_docs):
        v = rng.normal(size=(int(rng.integers(2, 6)), 16)).astype(np.float32)
        docs.append(v / np.linalg.norm(v, axis=-1, keepdims=True))
    return docs


def _index(n_docs, codec=None, **kw):
    rng = np.random.default_rng(0)
    docs = _docs(n_docs, rng)
    idx = MultiVectorIndex(dim=16, device="cpu", doc_maxlen=24,
                           n_centroids=16, **kw)
    if codec is not None:
        idx.set_codec(codec)
    idx.add([torch.from_numpy(v) for v in docs])
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
    """40 docs under the default ndocs: the device plan is refused, and
    where the port used to raise it now takes the host probe path and
    the dense corpus-wide rerank, as the reference does, and returns the
    reference's results (the same codec on both sides; ids equal
    tie-aware and scores to rtol 1e-5 / atol 1e-4: f32 sums in another
    order)."""
    import jax.numpy as jnp
    from repro.core.index import MultiVectorIndex as JIndex
    from repro_torch.core.maxsim import tie_aware_mismatches
    from repro_torch.core.plaid import device_probe_plan
    from repro_torch.core.quantization import ResidualCodec
    jidx = JIndex(dim=16, backend="plaid", doc_maxlen=24, n_centroids=16)
    jidx.add(_docs(40, np.random.default_rng(0)))
    c = jidx._plaid.codec
    codec = ResidualCodec(*(torch.tensor(np.asarray(a)) for a in
                            (c.centroids, c.cutoffs, c.values)), c.bits)
    idx, rng = _index(40, codec=codec)
    assert not device_probe_plan(idx._plaid, 3, idx.nprobe, idx.ndocs)[0]
    qs = rng.normal(size=(2, 3, 16)).astype(np.float32)
    S, I = idx.search_batch(torch.from_numpy(qs), k=5)
    jS, jI = jidx.search_batch(jnp.asarray(qs), k=5)
    assert tie_aware_mismatches(np.asarray(jI), np.asarray(jS), I, S,
                                1e-4) == 0
    np.testing.assert_allclose(S, np.asarray(jS), rtol=1e-5, atol=1e-4)


def test_retriever_evaluate_and_serve_raise_naming_roadmap():
    import repro_torch as rt
    model = rt.init_colbert(SMOKE, device="cpu")
    r = rt.Retriever(model, rt.MultiVectorIndex(dim=SMOKE.proj_dim,
                                                device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.evaluate(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.serve()


def test_unported_options_raise():
    with pytest.raises(ValueError):
        IndexSpec(quant_bits=3)


def test_lm_entry_points_without_device_need_cuda(monkeypatch):
    import repro_torch as rt
    cfg = rt.get_smoke_config("qwen3-0.6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.make_lm_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.make_lm_decode_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.init_transformer(cfg)
    model = rt.init_transformer(cfg, device="cpu")
    assert model.device.type == "cpu"
    step = rt.make_lm_prefill_step(cfg, device="cpu")
    logits, _ = step(model, {"tokens": np.zeros((1, 4), np.int32)})
    assert logits.shape == (1, cfg.vocab_size)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "moonshot-v1-16b-a3b",
                                  "dimenet", "wide-deep", "deepfm", "fm",
                                  "dlrm-rm2"])
def test_unported_architectures_raise(arch):
    from repro_torch.configs import get_config, get_smoke_config
    for get in (get_config, get_smoke_config):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_moe_config_raises_in_the_lm_entry_points():
    import dataclasses
    import repro_torch as rt
    from repro_torch.models.transformer import params_from_jax
    cfg = dataclasses.replace(rt.get_smoke_config("qwen3-0.6b"), moe=True,
                              n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.init_transformer(cfg, device="cpu")
    for build in (rt.make_lm_prefill_step, rt.make_lm_decode_step):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        params_from_jax({"moe_layers": {}})
