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
* The names and keywords the port lacked, each resolving and giving the
  reference's result on the same seeded inputs: the kernel subpackages'
  re-exports (``ward_pool``: assignments equal; ``plaid_probe``,
  ``maxsim_packed``: rtol / atol 1e-5), ``core.index.PARAM_KEYS`` and
  ``INDEX_PARAM_KEYS`` (the spec's object), ``pool_doc_embeddings(
  ward_kernel=)`` (masks equal, vectors to 1e-5), ``InvertedLists
  .list_for`` / ``lists_for`` and the capped device IVF (``list_cap``,
  ``overflow`` and every array equal at caps 0, 1 and 2; a view with
  overflow sends the plan to the host path), ``PLAIDIndex.add`` of a
  list (bitwise ``add_flat``, equal to the reference's ``add``),
  ``Indexer``'s ``pool_method`` / ``pool_factor`` / ``backend`` shorthand
  (the specs equal the reference ``Indexer``'s field by field; the build
  bitwise the spec build's) and ``EncodedDocs.nbytes()``.
* ``test_every_reference_name_has_a_counterpart``: an AST walk of both
  packages finds nothing the port lacks but ``BY_DESIGN``'s entries,
  each under the row of ``ROADMAP.md``'s table of by-design differences
  that explains it.
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


SUBPACKAGES = ("ward_pool", "plaid_probe", "maxsim_packed", "maxsim",
               "kmeans_assign", "quant", "flash_attention")


def test_kernels_import_builds_nothing():
    """A fresh process imports the package and its wrappers: no library
    is loaded and nothing is built. Then one fresh process a kernel
    subpackage, each importing ``repro_torch.kernels.<sub>`` first (and
    the reference's re-exports from it), and one importing
    ``repro_torch.core`` first: no import error (``ward_pool.ops`` ->
    ``core.ward`` -> ``core/__init__`` -> ``core.pooling`` ->
    ``ward_pool.ops`` is a cycle), no library loaded, no ``jax``."""
    check = (
        "import importlib\n"
        "from repro_torch.kernels.ward_pool import ward_assign, "
        "ward_assign_ref\n"
        "from repro_torch.kernels.plaid_probe import plaid_probe_scores\n"
        "from repro_torch.kernels.maxsim_packed import maxsim_packed_rerank\n"
        "for p in %r:\n"
        "    m = importlib.import_module(f'repro_torch.kernels.{p}.ops')\n"
        "    assert m._lib is None, p\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "print('ok')\n" % (SUBPACKAGES,))
    code = (
        "import sys, repro_torch.kernels as K\n"
        "from repro_torch.kernels import maxsim, flash_attention\n" + check)
    firsts = [f"repro_torch.kernels.{p}" for p in SUBPACKAGES]
    firsts.append("repro_torch.core")
    procs = [subprocess.Popen(
        [sys.executable, "-c", src], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for src in [code] + [f"import sys, {m}\n" + check for m in firsts]]
    for what, proc in zip(["kernels"] + firsts, procs):
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0 and out.strip() == "ok", (what, err)


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


# ------------------------------------------- the last names and keywords
def test_kernel_subpackages_reexport_the_reference_names():
    import repro.kernels.maxsim_packed as j_mp
    import repro.kernels.plaid_probe as j_pp
    import repro.kernels.ward_pool as j_wp
    import repro_torch.kernels.maxsim_packed as t_mp
    import repro_torch.kernels.plaid_probe as t_pp
    import repro_torch.kernels.ward_pool as t_wp
    from repro_torch.kernels.maxsim_packed import ops as mp_ops
    from repro_torch.kernels.plaid_probe import ops as pp_ops
    from repro_torch.kernels.ward_pool import ops as wp_ops
    from repro_torch.kernels.ward_pool import ref as wp_ref
    assert t_wp.ward_assign is wp_ops.ward_assign
    assert t_wp.ward_assign_ref is wp_ref.ward_assign_ref
    assert t_pp.plaid_probe_scores is pp_ops.plaid_probe_scores
    assert t_mp.maxsim_packed_rerank is mp_ops.maxsim_packed_rerank
    assert t_mp.__all__ == j_mp.__all__ == ["maxsim_packed_rerank"]
    for ref, port in ((j_wp, t_wp), (j_pp, t_pp), (j_mp, t_mp)):
        public = {n for n in vars(ref) if not n.startswith("_")
                  and callable(getattr(ref, n))
                  and getattr(ref, n).__module__.startswith(ref.__name__)}
        assert public <= set(port.__all__), (ref.__name__, public)
    with pytest.raises(AttributeError):
        t_wp.no_such_name


@pytest.mark.parametrize("factor", [2, 3])
def test_reexported_ward_assign_gives_the_reference_result(factor):
    from repro.kernels.ward_pool import ward_assign as j_ward_assign
    from repro.kernels.ward_pool import ward_assign_ref as j_ward_ref
    from repro_torch.kernels.ward_pool import ward_assign, ward_assign_ref
    rng = np.random.default_rng(factor)
    x = rng.normal(size=(3, 14, 8)).astype(np.float32)
    m = rng.random((3, 14)) < 0.8
    want = np.asarray(j_ward_ref(jnp.asarray(x), jnp.asarray(m), factor))
    np.testing.assert_array_equal(
        np.asarray(j_ward_assign(jnp.asarray(x), jnp.asarray(m), factor,
                                 impl="ref")), want)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    np.testing.assert_array_equal(ward_assign(xt, mt, factor).numpy(), want)
    np.testing.assert_array_equal(ward_assign_ref(xt, mt, factor).numpy(),
                                  want)


def test_reexported_probe_and_packed_rerank_give_the_reference_result():
    from repro.kernels.maxsim_packed.ref import maxsim_packed_rerank_ref
    from repro.kernels.plaid_probe import plaid_probe_scores as j_probe
    from repro_torch.kernels.maxsim_packed import maxsim_packed_rerank
    from repro_torch.kernels.plaid_probe import plaid_probe_scores
    rng = np.random.default_rng(9)
    Nq, Lq, dim, K, C, L, bits = 2, 5, 32, 12, 32, 7, 2   # C: a block
    q = rng.normal(size=(Nq, Lq, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qm = rng.random((Nq, Lq)) < 0.8
    cen = rng.normal(size=(K, dim)).astype(np.float32)
    cen /= np.linalg.norm(cen, axis=-1, keepdims=True)
    ids = rng.integers(0, K, size=(Nq, C, L)).astype(np.int32)
    dm = rng.random((Nq, C, L)) < 0.7
    cm = rng.random((Nq, C)) < 0.8
    want = np.asarray(j_probe(*map(jnp.asarray, (q, qm, cen, ids, dm, cm)),
                              t_cs=0.3, impl="ref"))
    got = plaid_probe_scores(*map(torch.from_numpy, (q, qm, cen, ids, dm,
                                                     cm)), t_cs=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    words = rng.integers(0, 2 ** 32, size=(Nq, C, L, dim * bits // 32),
                         dtype=np.uint64).astype(np.uint32)
    vals = (rng.normal(size=(dim, 1 << bits)) * 0.1).astype(np.float32)
    want = np.asarray(maxsim_packed_rerank_ref(
        *map(jnp.asarray, (q, qm, words, ids, dm, cen, vals)), bits=bits))
    got = maxsim_packed_rerank(*map(torch.from_numpy, (
        q, qm, words.view(np.int32), ids, dm, cen, vals)), bits=bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_index_param_keys_are_the_spec_object():
    from repro.core.index import PARAM_KEYS as J_PARAM_KEYS
    from repro_torch.core import index, spec
    assert index.INDEX_PARAM_KEYS is spec.INDEX_PARAM_KEYS
    assert index.PARAM_KEYS is spec.INDEX_PARAM_KEYS
    assert tuple(index.PARAM_KEYS) == tuple(J_PARAM_KEYS)


@pytest.mark.parametrize("method", ["ward", "sequential", "kmeans"])
def test_pool_doc_embeddings_ward_kernel(method):
    from repro.core.pooling import pool_doc_embeddings as j_pool
    from repro_torch.core.pooling import pool_doc_embeddings
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 16, 8)).astype(np.float32)
    m = rng.random((3, 16)) < 0.8
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    outs = {(wk, impl): pool_doc_embeddings(xt, mt, 2, method,
                                            ward_kernel=wk, impl=impl)
            for wk in ("auto", "ref") for impl in ("auto", "ref")}
    base = outs[("ref", "auto")]
    for p, pm in outs.values():            # either "ref" is the plain Ward
        assert torch.equal(p, base[0]) and torch.equal(pm, base[1])
    if method != "kmeans":      # k-means: the seeds differ across packages
        jp, jm = j_pool(jnp.asarray(x), jnp.asarray(m), 2, method,
                        ward_kernel="ref")
        np.testing.assert_array_equal(base[1].numpy(), np.asarray(jm))
        np.testing.assert_allclose(base[0].numpy(), np.asarray(jp),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="ward_kernel"):
        pool_doc_embeddings(xt, mt, 2, method, ward_kernel="fast")


def _ivf_pair(seed, n_docs=30, K=9):
    from repro.core.ivf import build_inverted_lists as j_build
    from repro_torch.core.ivf import build_inverted_lists
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, size=n_docs)
    vec2doc = np.repeat(np.arange(n_docs), lens)
    assign = rng.integers(0, K, size=len(vec2doc)).astype(np.int32)
    assign[assign == K - 1] = 0                 # one empty list
    return (j_build(assign, K), build_inverted_lists(assign, K), vec2doc,
            n_docs, K)


def test_inverted_lists_list_for_and_lists_for():
    jivf, tivf, _, _, K = _ivf_pair(0)
    for c in range(K):
        np.testing.assert_array_equal(tivf.list_for(c), jivf.list_for(c))
    for cs in ([0], [3, 1, 3], [K - 1], list(range(K)), []):
        got, want = tivf.lists_for(cs), jivf.lists_for(cs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [0, 1, 2])
def test_device_inverted_lists_list_cap(cap):
    from repro.core.ivf import build_device_inverted_lists as j_dev
    from repro_torch.core.ivf import build_device_inverted_lists
    jivf, tivf, vec2doc, n_docs, _ = _ivf_pair(1)
    want = j_dev(jivf, vec2doc, n_docs, cap)
    got = build_device_inverted_lists(tivf, vec2doc, n_docs, cap,
                                      device="cpu")
    assert (got.list_cap, got.overflow) == (want.list_cap, want.overflow)
    assert (got.overflow == 0) == (cap == 0)
    for name in ("doc_lists", "doc_valid", "doc_member", "offsets", "ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.device_bytes() == want.device_bytes()


def _plaid_pair(seed, n=40):
    from repro.core.index import MultiVectorIndex as JIndex
    from repro_torch.core.index import MultiVectorIndex
    rng = np.random.default_rng(seed)
    docs = [rng.normal(size=(int(rng.integers(2, 6)), 16)).astype(np.float32)
            for _ in range(n)]
    docs = [d / np.linalg.norm(d, axis=-1, keepdims=True) for d in docs]
    kw = dict(doc_maxlen=8, n_centroids=8, nprobe=2, ndocs=16)
    jidx = JIndex(dim=16, backend="plaid", **kw)
    jidx.add(docs)
    tidx = MultiVectorIndex(dim=16, device="cpu", **kw)
    tidx.set_codec(jidx._plaid.codec)
    tidx.add([torch.from_numpy(d) for d in docs])
    return jidx, tidx, rng


def test_device_ivf_list_cap_and_the_plan():
    from repro.core.plaid import device_probe_plan as j_plan
    from repro_torch.core.plaid import device_probe_plan
    jidx, tidx, _ = _plaid_pair(2)
    jp, tp = jidx._plaid, tidx._plaid
    exact = tp.device_ivf()
    assert tp.device_ivf() is exact and exact.overflow == 0
    capped = tp.device_ivf(list_cap=1)
    assert capped is not exact and tp.device_ivf() is exact     # no cache
    want = jp.device_ivf(list_cap=1)
    assert (capped.list_cap, capped.overflow) == (want.list_cap,
                                                  want.overflow)
    assert capped.overflow > 0
    np.testing.assert_array_equal(capped.doc_member.numpy(),
                                  np.asarray(want.doc_member))
    assert device_probe_plan(tp, 4, 2, 16, "device")[0] == j_plan(
        jp, 4, 2, 16, "device")[0]
    # a view with overflow is declined: the host path, as the reference
    jp._device_ivf, tp._device_ivf = want, capped
    assert j_plan(jp, 4, 2, 16, "device") == (False, None)
    assert device_probe_plan(tp, 4, 2, 16, "device") == (False, None)


def test_plaid_add_list_equals_add_flat_and_the_reference():
    """``PLAIDIndex.add`` of a list (tensors or numpy arrays) is
    ``add_flat`` of its rows, bit for bit, and the reference's ``add`` on
    the same codec."""
    import copy
    jidx, tidx, rng = _plaid_pair(3)
    new = [rng.normal(size=(int(rng.integers(1, 7)), 16)).astype(np.float32)
           for _ in range(6)]
    new = [d / np.linalg.norm(d, axis=-1, keepdims=True) for d in new]
    by_flat, by_np = copy.deepcopy(tidx._plaid), copy.deepcopy(tidx._plaid)
    ids_flat = by_flat.add_flat(torch.from_numpy(np.concatenate(new)),
                                [len(d) for d in new])
    ids_np = by_np.add(new)
    ids = tidx._plaid.add([torch.from_numpy(d) for d in new])
    p = tidx._plaid
    for other, other_ids in ((by_flat, ids_flat), (by_np, ids_np)):
        np.testing.assert_array_equal(ids, other_ids)
        assert torch.equal(p.assignments, other.assignments)
        assert torch.equal(p.codes, other.codes)
        np.testing.assert_array_equal(p.doc_offsets, other.doc_offsets)
    np.testing.assert_array_equal(ids, jidx._plaid.add(new))
    np.testing.assert_array_equal(p.assignments.numpy(),
                                  np.asarray(jidx._plaid.assignments))
    np.testing.assert_array_equal(p.codes.numpy().view(np.uint32),
                                  np.asarray(jidx._plaid.codes))
    np.testing.assert_array_equal(p.vec2doc, jidx._plaid.vec2doc)
    np.testing.assert_array_equal(p.doc_offsets, jidx._plaid.doc_offsets)
    assert len(p.add([])) == 0 and p.n_docs == jidx._plaid.n_docs


@pytest.fixture(scope="module")
def smoke_encoders():
    """The SMOKE encoder in f32 in both packages (the JAX weights carried
    over by ``params_from_jax``) and a small seeded corpus."""
    import dataclasses
    import repro_torch as rt
    from repro.configs.colbertv2 import SMOKE as J_SMOKE
    from repro.models import colbert as jcol
    from repro_torch.data.corpus import DatasetSpec, SyntheticRetrievalCorpus
    from repro_torch.models import colbert as tcol
    jcfg = dataclasses.replace(J_SMOKE, trunk=dataclasses.replace(
        J_SMOKE.trunk, dtype="float32"))
    tcfg = dataclasses.replace(rt.SMOKE, trunk=dataclasses.replace(
        rt.SMOKE.trunk, dtype="float32"))
    params = jcol.init_colbert(jax.random.PRNGKey(0), jcfg)
    model = tcol.ColBERT(tcfg, device="cpu").load_params(
        tcol.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    corpus = SyntheticRetrievalCorpus(DatasetSpec(
        "surface", n_docs=30, n_queries=4, n_topics=4, doc_len_mean=20,
        doc_len_std=4, seed=6), vocab_size=tcfg.trunk.vocab_size)
    return (params, jcfg, model, corpus.doc_token_batch(tcfg.doc_maxlen - 2),
            corpus.query_token_batch(tcfg.query_maxlen - 2))


def _payload_bytes(root):
    import os
    from repro_torch.core.persist import read_manifest
    out = {}
    for name, p in read_manifest(root)["payloads"].items():
        with open(os.path.join(root, p["file"]), "rb") as fh:
            out[name] = fh.read()
    return out


SHORTHANDS = [dict(pool_method="ward", pool_factor=2, backend="plaid"),
              dict(pool_method="sequential", pool_factor=3, backend="flat"),
              dict(pool_factor=2), dict(backend="hnsw")]


@pytest.mark.parametrize("kw", SHORTHANDS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_indexer_shorthand_resolves_the_reference_specs(smoke_encoders, kw):
    import dataclasses
    from repro.retrieval.indexer import Indexer as JIndexer
    from repro_torch.retrieval.indexer import Indexer
    params, jcfg, model, _, _ = smoke_encoders
    got = Indexer(model, device="cpu", **kw)
    want = JIndexer(params, jcfg, **kw)
    for g, w in ((got.index_spec, want.index_spec),
                 (got.pooling, want.pooling)):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert set(gd) == set(wd) and gd == wd, (gd, wd)
    assert (got.pool_method, got.pool_factor, got.backend) == (
        want.pool_method, want.pool_factor, want.backend)


def test_indexer_shorthand_mixed_with_its_spec_raises(smoke_encoders):
    import repro_torch as rt
    from repro_torch.retrieval.indexer import Indexer
    model = smoke_encoders[2]
    with pytest.raises(TypeError, match="index_spec"):
        Indexer(model, index_spec=rt.IndexSpec(), backend="flat",
                device="cpu")
    with pytest.raises(TypeError, match="index_spec"):
        Indexer(model, index_spec=rt.IndexSpec(), nprobe=4, device="cpu")
    with pytest.raises(TypeError, match="pooling_spec"):
        Indexer(model, pooling_spec=rt.PoolingSpec("ward", 2), pool_factor=2,
                device="cpu")
    with pytest.warns(DeprecationWarning, match="index_spec"):
        ix = Indexer(model, backend="plaid", nprobe=4, ndocs=64,
                     device="cpu")
    assert (ix.index_spec.nprobe, ix.index_spec.ndocs) == (4, 64)


def test_indexer_shorthand_builds_the_spec_index(smoke_encoders, tmp_path):
    """Payloads byte-equal and search results bitwise those of the
    spec-built Indexer."""
    import repro_torch as rt
    _, _, model, toks, queries = smoke_encoders
    short = rt.Indexer(model, pool_method="ward", pool_factor=2,
                       backend="plaid", encode_batch=8, device="cpu")
    spec = rt.Indexer(model, index_spec=rt.IndexSpec.from_config(
        model.cfg, backend="plaid"), pooling_spec=rt.PoolingSpec("ward", 2),
        encode_batch=8, device="cpu")
    results = []
    for name, ix in (("short", short), ("spec", spec)):
        index, _ = ix.build(toks, out_dir=str(tmp_path / name))
        results.append((_payload_bytes(str(tmp_path / name)),
                        rt.Searcher(model, index).search(queries, k=5)))
    (pa, (Sa, Ia)), (pb, (Sb, Ib)) = results
    assert pa.keys() == pb.keys() and all(pa[k] == pb[k] for k in pa)
    np.testing.assert_array_equal(Ia, Ib)
    np.testing.assert_array_equal(Sa, Sb)


def test_encoded_docs_nbytes(smoke_encoders):
    from repro.retrieval.indexer import EncodedDocs as JEncoded
    from repro_torch.retrieval.indexer import EncodedDocs
    params, jcfg, model, toks, _ = smoke_encoders
    enc = EncodedDocs.encode(model, toks, encode_batch=8)
    want = sum(v.numel() * v.element_size() + emit.numel()
               for v, emit, _ in enc.batches)
    assert enc.nbytes() == want > 0
    assert enc.nbytes() == JEncoded.encode(params, jcfg, toks,
                                           encode_batch=8).nbytes()


# ------------------------------------------------------------- the guard
# What the AST walk finds that the port leaves out on purpose, by the row
# of ROADMAP.md's table of by-design differences that explains it (the
# start of the row's first column, without its backquotes). A finding
# is "module: Name", "module: Class.member", "module: function(keyword=)",
# "module: function(**)" or "module: <module>".
_K = "kernels/{}/ops.py: {}"
_COLBERT_PARAMS = [
    f"{m}: {f}({a}=)" for m, fs in (
        ("api.py", ("Retriever.__init__", "Retriever.build",
                    "Retriever.load")),
        ("retrieval/indexer.py", ("Indexer.__init__", "EncodedDocs.encode")),
        ("retrieval/searcher.py", ("Searcher.__init__", "Searcher.from_dir")),
        ("retrieval/evaluate.py", ("evaluate_pooling",)),
        ("eval/sweep.py", ("QualitySweep.__init__",)),
        ("models/colbert.py", ("encode_docs", "encode_queries", "colbert_loss",
                               "colbert_train_step")))
    for f in fs for a in ("params", "cfg")] + [
    "retrieval/cascade.py: build_cascade(indexer_params=)",
    "retrieval/cascade.py: build_cascade(cfg=)"]
BY_DESIGN = {
    "kernels/*/kernel.py": [
        f"kernels/{k}/kernel.py: <module>" for k in (
            "flash_attention", "kmeans_assign", "maxsim", "maxsim_packed",
            "plaid_probe", "quant", "ward_pool")],
    "the wrappers' block_* tiling arguments": [
        _K.format("kmeans_assign", "kmeans_assign(block_n=)"),
        _K.format("maxsim", "maxsim(block_q=)"),
        _K.format("maxsim", "maxsim(block_d=)"),
        _K.format("maxsim", "maxsim_rerank(block_s=)"),
        _K.format("ward_pool", "ward_assign(block_b=)"),
        _K.format("maxsim_packed", "maxsim_packed_rerank(block_s=)"),
        _K.format("flash_attention", "flash_attention(block_q=)"),
        _K.format("flash_attention", "flash_attention(block_k=)"),
        _K.format("plaid_probe", "plaid_probe_scores(block_c=)"),
        _K.format("quant", "dequant_score(block_m=)")],
    "kernels/ward_pool/ops.py resolve_impl": [
        "kernels/ward_pool/ops.py: resolve_impl"],
    "sharding/params.py to_shardings": ["sharding/params.py: to_shardings"],
    "roofline/hlo_flops.py dot_flops_in_hlo, roofline/analysis.py "
    "collective_bytes_from_hlo": [
        "roofline/hlo_flops.py: <module>",
        "roofline/analysis.py: collective_bytes_from_hlo"],
    "roofline/hw.py (TPU v5e: MXU_TILE, VMEM_BYTES, ICI_LINK_BW)": [
        f"roofline/hw.py: {n}" for n in ("ICI_LINK_BW", "MXU_TILE",
                                         "VMEM_BYTES")],
    "models/transformer.py forward, logits_head, init_cache, prefill, "
    "decode_step": [
        f"models/transformer.py: {n}" for n in (
            "forward", "logits_head", "init_cache", "prefill",
            "decode_step")],
    "models/attention.py init_attention, attention_forward(p, ...), "
    "attention_decode(p, ...); models/mlp.py init_mlp, mlp; models/moe.py "
    "init_moe": [
        "models/attention.py: init_attention",
        "models/attention.py: attention_forward(p=)",
        "models/attention.py: attention_decode(p=)",
        "models/mlp.py: init_mlp", "models/mlp.py: mlp",
        "models/moe.py: init_moe"],
    "models/layers.py init_dense / dense, init_rmsnorm / rmsnorm, "
    "init_layernorm / layernorm, init_norm, init_embed / embed, "
    "trunc_normal, lecun_normal, norm(kind, p, x)": [
        f"models/layers.py: {n}" for n in (
            "init_dense", "dense", "init_rmsnorm", "rmsnorm",
            "init_layernorm", "layernorm", "init_norm", "init_embed",
            "embed", "trunc_normal", "lecun_normal", "norm(p=)",
            "norm(x=)")],
    "models/layers.py tree_size, tree_bytes, tree_paths": [
        f"models/layers.py: {n}" for n in ("tree_size", "tree_bytes",
                                           "tree_paths")],
    "the ColBERT (params, cfg) pair": _COLBERT_PARAMS,
    "the other families' params tree": [
        "models/transformer.py: lm_loss(params=)",
        "models/gnn/dimenet.py: dimenet_forward(params=)",
        "models/gnn/dimenet.py: dimenet_loss(params=)",
        "models/recsys/embedding.py: embedding_bag(params=)",
        "models/recsys/embedding.py: embedding_bag_ragged(params=)",
        "models/recsys/models.py: recsys_forward(params=)",
        "models/recsys/models.py: recsys_loss(params=)",
        "models/recsys/models.py: score_candidates(params=)",
        "train/trainer.py: Trainer.__init__(params=)"],
    "core/plaid.py build_plaid_index(doc_vectors, codec)": [
        "core/plaid.py: build_plaid_index(doc_vectors=)"],
    "train/checkpoint.py restore(shardings=)": [
        "train/checkpoint.py: CheckpointManager.restore(shardings=)"],
    "configs scan_layers (transformers), unroll_scans (DimeNet)": [
        "configs/base.py: TransformerConfig.scan_layers",
        "configs/base.py: DimeNetConfig.unroll_scans"],
    "JAX PRNG key=": [
        "core/kmeans.py: kmeans_train(key=)",
        "models/colbert.py: init_colbert(key=)",
        "models/transformer.py: init_transformer(key=)",
        "models/gnn/dimenet.py: init_dimenet(key=)",
        "models/recsys/models.py: init_recsys(key=)",
        "models/recsys/embedding.py: init_tables(key=)",
        "models/recsys/embedding.py: init_tables(vocab_sizes=)",
        "models/recsys/embedding.py: init_tables(embed_dim=)",
        "models/recsys/embedding.py: init_tables(dtype=)"],
    "core/maxsim.py maxsim_scores_blocked(unroll=)": [
        "core/maxsim.py: maxsim_scores_blocked(unroll=)"],
    "launch/dryrun.py run_cell(keep_hlo=)": [
        "launch/dryrun.py: run_cell(keep_hlo=)"],
    "sharding/params.py opt_state_specs(opt_state_shape, ...)": [
        "sharding/params.py: opt_state_specs(opt_state_shape=)"],
    "core/docstore.py DocStore(init_capacity=)": [
        "core/docstore.py: DocStore.__init__(init_capacity=)"],
    "train/trainer.py Trainer(donate=)": [
        "train/trainer.py: Trainer.__init__(donate=)"],
}


def _names_listed(tree, value):
    """The names of an ``__all__`` value: a list or tuple of strings, or
    ``sorted(<dict>)`` of a module-level dict's keys."""
    import ast
    if isinstance(value, (ast.List, ast.Tuple)):
        return [e.value for e in value.elts]
    src = value.args[0].id                       # sorted(_EXPORTS)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == src for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"unread __all__: {ast.dump(value)}")


def _surface(tree, is_init):
    """{public name: its def or class node, or None}: what a module
    defines (functions, classes, constants) and, in an ``__init__.py``,
    what it imports or lists in ``__all__``."""
    import ast
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in getattr(node, "targets", [getattr(node, "target", None)]):
                if getattr(t, "id", None) == "__all__":
                    out.update(dict.fromkeys(_names_listed(tree, node.value)))
                elif isinstance(t, ast.Name):
                    out[t.id] = None
        elif is_init and isinstance(node, (ast.Import, ast.ImportFrom)):
            for al in node.names:
                out[(al.asname or al.name).split(".")[0]] = None
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _bindings(tree):
    """Every name a module binds at its top level (imports included), and
    the names its ``__all__`` lists (a lazy ``__getattr__`` binds them)."""
    import ast
    out = {}
    for node in tree.body:
        for sub in ast.walk(node) if isinstance(node, (ast.If, ast.Try)) \
                else [node]:
            if isinstance(sub, (ast.FunctionDef, ast.ClassDef)):
                out.setdefault(sub.name, sub)
            elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                for al in sub.names:
                    out.setdefault((al.asname or al.name).split(".")[0], None)
            elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                for t in getattr(sub, "targets", [getattr(sub, "target",
                                                          None)]):
                    if getattr(t, "id", None) == "__all__":
                        for n in _names_listed(tree, sub.value):
                            out.setdefault(n, None)
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            out.setdefault(n.id, None)
    return out


def _members(cls):
    """{name: def node or None}: a class's methods and its class-level
    (dataclass) fields."""
    import ast
    out = {}
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.AnnAssign):
            out[node.target.id] = None
        elif isinstance(node, ast.Assign):
            out.update(dict.fromkeys(t.id for t in node.targets
                                     if isinstance(t, ast.Name)))
    return out


def _keywords(ref_fn, port_fn, where):
    """Each of the reference's named parameters missing from the port's
    function, and a ``**`` the port lacks."""
    def names(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                if x.arg not in ("self", "cls")]
    have = set(names(port_fn))
    out = [f"{where}({a}=)" for a in names(ref_fn) if a not in have]
    if ref_fn.args.kwarg is not None and port_fn.args.kwarg is None:
        out.append(f"{where}(**)")
    return out


def _walk_findings():
    import ast
    import os
    root = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    ref_root = os.path.join(root, "repro")
    findings = []
    for dirpath, _, files in sorted(os.walk(ref_root)):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
            rel = rel.replace(os.sep, "/")
            port_path = os.path.join(root, "repro_torch", rel)
            if not os.path.exists(port_path):
                findings.append(f"{rel}: <module>")
                continue
            with open(os.path.join(ref_root, rel)) as fh:
                ref = ast.parse(fh.read())
            with open(port_path) as fh:
                port = _bindings(ast.parse(fh.read()))
            for name, node in sorted(_surface(ref, f == "__init__.py")
                                     .items()):
                if name not in port:
                    findings.append(f"{rel}: {name}")
                    continue
                other = port[name]
                if isinstance(node, ast.FunctionDef) and isinstance(
                        other, ast.FunctionDef):
                    findings += _keywords(node, other, f"{rel}: {name}")
                if not (isinstance(node, ast.ClassDef)
                        and isinstance(other, ast.ClassDef)):
                    continue
                have = _members(other)
                for m, fn in _members(node).items():
                    if m.startswith("_") and m != "__init__":
                        continue
                    if m not in have:
                        findings.append(f"{rel}: {name}.{m}")
                    elif isinstance(fn, ast.FunctionDef) and isinstance(
                            have[m], ast.FunctionDef):
                        findings += _keywords(fn, have[m],
                                              f"{rel}: {name}.{m}")
    return findings


def test_every_reference_name_has_a_counterpart():
    """An AST walk of ``src/repro/**.py`` and ``src/repro_torch/**.py``
    (nothing imported): every public name a reference module defines or
    an ``__init__.py`` re-exports, every public method and dataclass
    field of its classes, and every keyword of those, has a counterpart
    at the same module path in the port, apart from ``BY_DESIGN``'s
    entries; and every entry there is still a finding."""
    findings = _walk_findings()
    excused = [f for row in BY_DESIGN.values() for f in row]
    assert len(excused) == len(set(excused))
    assert sorted(set(findings) - set(excused)) == []
    assert sorted(set(excused) - set(findings)) == []
