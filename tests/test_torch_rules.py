"""Rules of the port (``src/repro_torch``):

* no module imports ``jax`` or the JAX package ``repro`` (checked in a
  fresh interpreter, so nothing imported by the tests leaks in);
* entry points given no device run on ``cuda`` and raise without one —
  they never fall back to the CPU quietly;
* CPU tensors run the kernels' plain versions (no launch is counted);
* every kernel wrapper refuses a call autograd would record (no kernel
  has a backward), on the CPU as on the card;
* where the reference takes the host probe path and the dense
  fallback, so does the port, with the reference's results;
* every architecture of the reference has its configs, field-equal.
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
              "configs.qwen2_5_14b", "core.sharded", "core.spec", "api",
              "core.replicated", "eval.metrics", "eval.sweep",
              "launch.engine", "launch.serve", "retrieval.evaluate",
              "train.optimizer", "train.checkpoint", "train.trainer",
              "train.params", "data.pipeline", "launch.train",
              "models.moe", "models.gnn.dimenet", "models.gnn.sampler",
              "models.recsys.embedding", "models.recsys.models",
              "configs.kimi_k2_1t_a32b", "configs.moonshot_v1_16b_a3b",
              "configs.dimenet", "configs.wide_deep", "configs.deepfm",
              "configs.fm", "configs.dlrm_rm2", "launch.mesh",
              "sharding", "sharding.api", "sharding.params",
              "launch.input_specs", "launch.dryrun", "roofline",
              "roofline.hw", "roofline.analysis", "roofline.packed",
              "roofline.probe", "roofline.run", "roofline.hillclimb",
              "roofline.report"):
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
    from repro_torch.eval import QualitySweep, compute_metrics
    from repro_torch.launch.engine import ServingEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_metrics(np.zeros((1, 2), np.int64), [{0: 1}], ("ndcg@2",))
    with pytest.raises(RuntimeError, match="CUDA"):
        QualitySweep(model, None)
    from repro_torch.launch import train as launch_train
    lm_cfg = rt.get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.make_lm_train_step(lm_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.Trainer(lambda m, b: rt.colbert_loss(m, b["q"], b["d"]), model,
                   rt.TrainConfig())
    searcher = rt.Searcher(model, MultiVectorIndex(dim=8, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(searcher)
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


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dimenet",
                                  "dlrm-rm2"])
def test_family_entry_points_without_device_need_cuda(monkeypatch, arch):
    """The MoE trunk's, DimeNet's and the recsys models' ``init_*`` and
    step builders resolve to ``cuda`` without a device and raise without
    a card; given the CPU they run there."""
    import repro_torch as rt
    cfg = rt.get_smoke_config(arch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if arch == "dimenet":
        inits = (rt.init_dimenet, rt.DimeNet)
        builders = (lambda **kw: rt.make_gnn_train_step(cfg, "graph", **kw),)
    elif arch == "dlrm-rm2":
        inits = (rt.init_recsys, rt.Recsys)
        builders = tuple(lambda b=b, **kw: b(cfg, **kw) for b in (
            rt.make_recsys_train_step, rt.make_recsys_serve_step,
            rt.make_recsys_retrieval_step))
    else:
        inits = (rt.init_transformer, rt.TransformerLM)
        builders = tuple(lambda b=b, **kw: b(cfg, **kw) for b in (
            rt.make_lm_train_step, rt.make_lm_prefill_step,
            rt.make_lm_decode_step))
    for init in inits:
        with pytest.raises(RuntimeError, match="CUDA"):
            init(cfg)
        assert next(init(cfg, device="cpu").parameters()).device.type == \
            "cpu"
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        assert build(device="cpu") is not None


# The reference's fields the port leaves out. ``scan_layers`` (layers
# under one lax.scan) has no PyTorch meaning: the port loops over its
# layers. DimeNet's ``unroll_scans`` is read by no ported module.
# ColBERT's ``maxsim_block`` is the port's too (the search step's trace
# on ``meta`` scores in blocks of it).
JAX_ONLY = {"TransformerConfig": {"scan_layers"},
            "DimeNetConfig": {"unroll_scans"}, "RecsysConfig": set(),
            "ColbertConfig": set()}


def _fields_equal(t, j):
    import dataclasses
    assert type(t).__name__ == type(j).__name__
    td = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    jd = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    assert set(jd) - set(td) == JAX_ONLY[type(j).__name__]
    assert set(td) <= set(jd)
    for k, v in td.items():
        if dataclasses.is_dataclass(v):
            _fields_equal(v, jd[k])
        else:
            assert v == jd[k], (k, v, jd[k])


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "moonshot-v1-16b-a3b",
                                  "qwen2.5-14b", "qwen3-0.6b", "qwen1.5-0.5b",
                                  "dimenet", "wide-deep", "deepfm", "fm",
                                  "dlrm-rm2", "colbertv2"])
def test_every_architecture_has_reference_configs(arch):
    """Each of the reference's 11 architectures: ``get_config`` and
    ``get_smoke_config`` field-equal to the reference's (the trunk of
    ColBERT too), the registries equal; an unknown name raises
    ``KeyError``."""
    from repro import configs as jconfigs
    from repro_torch import configs
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert arch in configs.ALL_ARCHS
    _fields_equal(configs.get_config(arch), jconfigs.get_config(arch))
    _fields_equal(configs.get_smoke_config(arch),
                  jconfigs.get_smoke_config(arch))
    t, j = configs.get_config(arch), jconfigs.get_config(arch)
    if hasattr(j, "param_count"):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    from repro.configs.base import shapes_for as jshapes
    from repro_torch.configs.base import shapes_for
    assert [(c.name, c.kind, c.dims) for c in shapes_for(t)] == [
        (c.name, c.kind, c.dims) for c in jshapes(j)]
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    with pytest.raises(KeyError):
        configs.get_smoke_config("no-such-arch")


def _kernel_calls():
    """name -> a call of each kernel wrapper on small CPU tensors, its
    float inputs requiring grad (the plain versions run)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bh)
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    from repro_torch.kernels.maxsim.ops import (maxsim, maxsim_rerank,
                                                maxsim_rerank_indexed)
    from repro_torch.kernels.maxsim_packed.ops import maxsim_packed_rerank
    from repro_torch.kernels.plaid_probe.ops import plaid_probe_scores
    from repro_torch.kernels.quant.ops import dequant_score
    from repro_torch.kernels.ward_pool.ops import ward_assign
    g = torch.Generator().manual_seed(0)

    def f(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()

    def ones(*shape):
        return torch.ones(*shape, dtype=torch.bool)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, dtype=torch.int32)

    q, q16, qm = f(2, 3, 8), f(2, 3, 16), ones(2, 3)     # 2-bit: dim 16
    return {
        "ward_pool": lambda: ward_assign(f(2, 6, 8), ones(2, 6), 2),
        "plaid_probe": lambda: plaid_probe_scores(
            q, qm, f(4, 8), ints(4, 2, 5, 3), ones(2, 5, 3), ones(2, 5),
            t_cs=0.3),
        "maxsim_packed": lambda: maxsim_packed_rerank(
            q16, qm, ints(2 ** 30, 2, 5, 3, 1), ints(4, 2, 5, 3),
            ones(2, 5, 3), f(4, 16), f(16, 4), bits=2),
        "maxsim": lambda: maxsim(q, qm, f(5, 4, 8), ones(5, 4)),
        "maxsim_rerank": lambda: maxsim_rerank(q, qm, f(2, 5, 4, 8),
                                               ones(2, 5, 4)),
        "maxsim_rerank_indexed": lambda: maxsim_rerank_indexed(
            q, qm, f(5, 4, 8), ones(5, 4), ints(5, 2, 3), ones(2, 3)),
        "kmeans_assign": lambda: kmeans_assign(f(2, 6, 8), f(2, 3, 8)),
        "dequant_score": lambda: dequant_score(
            ints(2 ** 30, 5, 1), ints(4, 5), f(4, 16), f(16, 4), f(3, 16)),
        "flash_attention": lambda: flash_attention(
            f(1, 2, 4, 8), f(1, 1, 4, 8), f(1, 1, 4, 8)),
        "flash_attention_bh": lambda: flash_attention_bh(
            f(2, 4, 8), f(1, 4, 8), f(1, 4, 8)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_raise_under_autograd(name):
    """No kernel has a backward (nor has its Pallas counterpart), so a
    wrapper refuses a call autograd would record, on the CPU as on the
    card; under ``no_grad`` the same call runs."""
    call = _kernel_calls()[name]
    with pytest.raises(RuntimeError, match="no backward|neither package"):
        call()
    with torch.no_grad():
        out = call()
    assert all(not t.requires_grad for t in (
        out if isinstance(out, tuple) else (out,)))
