"""The port's public surface against the JAX package's, name by name.

* For ``repro`` / ``repro.retrieval`` / ``repro.data`` /
  ``repro.kernels`` / ``repro.core`` / ``repro.eval``: every name in the
  JAX ``__all__`` is in the port counterpart's ``__all__`` and resolves
  there.
* ``repro_torch.kernels``: the five wrappers under the reference's
  names, although three are also subpackages (``maxsim``,
  ``kmeans_assign``, ``flash_attention``): the attribute is the
  function, ``from repro_torch.kernels.maxsim import ops`` still finds
  the subpackage, ``launch_counts()`` is unchanged, and importing them
  built or loaded no kernel.
* The last small functions, each against the JAX one on seeded numpy
  inputs: ``core.maxsim.maxsim`` and ``maxsim_rerank`` (rtol 1e-5, atol
  1e-5: f32 sums in another order), ``core.ward.ward_cluster``
  (assignments equal), ``configs.base.asdict`` (equal on every field the
  port's configs have, on every config; the reference's extra fields are
  the two it leaves out by design), ``launch.input_specs.input_specs``
  (shapes and dtypes equal to the reference's ``ShapeDtypeStruct``s on a
  one-rank mesh), ``kernels.flash_attention.ref.attention_ref`` (causal
  and not, GQA; atol / rtol 1e-5) and
  ``kernels.maxsim_packed.ref.decode_rows_ref`` (atol 1e-6).
"""
import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import asdict as j_asdict
from repro.core.maxsim import maxsim as j_maxsim
from repro.core.maxsim import maxsim_rerank as j_maxsim_rerank
from repro.core.ward import ward_cluster as j_ward_cluster
from repro.kernels.flash_attention.ref import attention_ref as j_attention
from repro.kernels.maxsim_packed.ref import decode_rows_ref as j_decode
from repro.launch import input_specs as j_specs
from repro.models.layers import tree_paths
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.configs.base import asdict
from repro_torch.core.maxsim import maxsim, maxsim_rerank
from repro_torch.core.ward import ward_cluster
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.maxsim_packed.ref import decode_rows_ref
from repro_torch.launch import input_specs as t_specs
from repro_torch.launch.mesh import make_mesh, process_group

RTOL = ATOL = 1e-5
PACKAGES = ["", ".retrieval", ".data", ".kernels", ".core", ".eval"]
# reference config fields the port leaves out (``configs/base.py``)
LEFT_OUT = {"TransformerConfig": {"scan_layers"},
            "DimeNetConfig": {"unroll_scans"}}


@pytest.mark.parametrize("sub", PACKAGES)
def test_reference_exports_resolve_in_port(sub):
    ref = importlib.import_module("repro" + sub)
    port = importlib.import_module("repro_torch" + sub)
    missing = sorted(set(ref.__all__) - set(port.__all__))
    assert not missing, missing
    for name in ref.__all__:
        assert getattr(port, name) is not None, name


def test_kernels_names_shadow_subpackages():
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.maxsim import ops
    from repro_torch.kernels.maxsim_packed import ops as mp_ops
    from repro_torch.kernels.quant import ops as q_ops
    assert K.maxsim is ops.maxsim and callable(K.maxsim)
    assert K.kmeans_assign is km_ops.kmeans_assign
    assert K.flash_attention is fa_ops.flash_attention
    assert K.maxsim_packed_rerank is mp_ops.maxsim_packed_rerank
    assert K.dequant_score is q_ops.dequant_score
    assert ops.__name__ == "repro_torch.kernels.maxsim.ops"
    counts = K.launch_counts()
    assert tuple(counts) == K.KERNELS and len(K.KERNELS) == 8
    assert all(isinstance(v, int) for v in counts.values())
    K.reset_launch_counts()
    assert set(K.launch_counts().values()) == {0}


def test_kernels_import_builds_nothing():
    """A fresh process imports the package and its wrappers: no library
    is loaded and nothing is built."""
    code = (
        "import sys, repro_torch.kernels as K\n"
        "from repro_torch.kernels import maxsim, flash_attention\n"
        "import importlib\n"
        "for p in ('ward_pool', 'plaid_probe', 'maxsim_packed', 'maxsim',"
        " 'kmeans_assign', 'quant', 'flash_attention'):\n"
        "    m = importlib.import_module(f'repro_torch.kernels.{p}.ops')\n"
        "    assert m._lib is None, p\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maxsim_one_pair(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    d = rng.normal(size=(13, 16)).astype(np.float32)
    qm, dm = rng.random(9) < 0.8, rng.random(13) < 0.6
    dm[seed] = True
    want = float(j_maxsim(*map(jnp.asarray, (q, qm, d, dm))))
    got = maxsim(*map(torch.from_numpy, (q, qm, d, dm)))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    # no valid doc token: every query token adds 0
    none = maxsim(*map(torch.from_numpy, (q, qm, d, np.zeros(13, bool))))
    assert float(none) == float(j_maxsim(*map(jnp.asarray, (
        q, qm, d, np.zeros(13, bool))))) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_maxsim_rerank_gathered(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, 7, 16)).astype(np.float32)
    d = rng.normal(size=(3, 5, 11, 16)).astype(np.float32)
    qm, dm = rng.random((3, 7)) < 0.8, rng.random((3, 5, 11)) < 0.6
    dm[0, 1] = False                          # a candidate with no tokens
    want = np.asarray(j_maxsim_rerank(*map(jnp.asarray, (q, qm, d, dm))))
    got = maxsim_rerank(*map(torch.from_numpy, (q, qm, d, dm)))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k_target", [0, 1, 4, 9, 40])
def test_ward_cluster_one_document(k_target):
    rng = np.random.default_rng(k_target)
    x = rng.normal(size=(24, 16)).astype(np.float32)
    m = rng.random(24) < 0.7
    want = np.asarray(j_ward_cluster(jnp.asarray(x), jnp.asarray(m),
                                     k_target))
    got = ward_cluster(torch.from_numpy(x), torch.from_numpy(m), k_target)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _same_fields(port: dict, ref: dict, where: str):
    for k, v in port.items():
        assert k in ref, f"{where}.{k}"
        if isinstance(v, dict):
            _same_fields(v, ref[k], f"{where}.{k}")
        else:
            assert v == ref[k], f"{where}.{k}: {v!r} != {ref[k]!r}"


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_asdict_every_config(arch, smoke):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    jcfg = (j_get_smoke_config if smoke else j_get_config)(arch)
    got, want = asdict(cfg), j_asdict(jcfg)
    _same_fields(got, want, arch)
    extra = set(want) - set(got)
    assert extra == LEFT_OUT.get(type(cfg).__name__, set()), extra


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "moonshot-v1-16b-a3b",
                                  "dimenet", "dlrm-rm2", "colbertv2"])
def test_input_specs_shapes_and_dtypes(arch):
    cell = t_specs.all_cells(arch)[0]
    j_mesh = jax.make_mesh((1, 1), ("data", "model"))
    with process_group("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        got = t_specs.input_specs(arch, cell, mesh)
    want = j_specs.input_specs(arch, cell, j_mesh)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        gl, wl = _port_leaves(g), dict(tree_paths(w))
        # the reference encoder's unread lm_head has no port counterpart
        assert set(gl) <= set(wl) and not (
            set(wl) - set(gl) - {"trunk/lm_head/w"}), (arch, i)
        for path, leaf in gl.items():
            ref = wl[path]
            if isinstance(leaf, list):          # a stack of L layers
                shape = (len(leaf), *leaf[0].shape)
                dtypes = {str(t.dtype) for t in leaf}
            elif isinstance(leaf, int):         # the optimizer's step
                assert tuple(ref.shape) == (), path
                continue
            else:
                assert leaf.is_meta, path
                shape, dtypes = tuple(leaf.shape), {str(leaf.dtype)}
            assert shape == tuple(ref.shape), (path, shape, ref.shape)
            assert dtypes == {f"torch.{np.dtype(ref.dtype).name}"}, path


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 8, 12, 16, 2), (1, 2, 5, 5, 8, 2),
                                   (1, 6, 7, 10, 16, 3)])
def test_attention_ref(causal, shape):
    B, H, Sq, Skv, dh, KV = shape
    rng = np.random.default_rng(Sq * Skv)
    q = rng.normal(size=(B, H, Sq, dh)).astype(np.float32)
    k = rng.normal(size=(B, KV, Skv, dh)).astype(np.float32)
    v = rng.normal(size=(B, KV, Skv, dh)).astype(np.float32)
    want = np.asarray(j_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal))
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_decode_rows_ref_at_the_reference_path(bits):
    rng = np.random.default_rng(bits)
    dim, K, M = 32, 8, 20
    W = dim * bits // 32
    words = rng.integers(0, 2 ** 32, size=(M, W), dtype=np.uint32)
    ids = rng.integers(0, K, M).astype(np.int32)
    cen = rng.normal(size=(K, dim)).astype(np.float32)
    vals = rng.normal(size=(dim, 2 ** bits)).astype(np.float32) * 0.1
    want = np.asarray(j_decode(jnp.asarray(words), jnp.asarray(ids),
                               jnp.asarray(cen), jnp.asarray(vals), bits))
    got = decode_rows_ref(torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(ids), torch.from_numpy(cen),
                          torch.from_numpy(vals), bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
