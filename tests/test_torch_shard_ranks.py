"""The port's models over a mesh, on four gloo ranks, held to the port on
one process and, for one LM and one recsys model, to the JAX package.

Each of the meshes (2, 2) and (1, 4) ("data", "model") is four processes
of ``tests/torch_shard_ranks.py`` (a ``FileStore`` rendezvous, one
thread each, a 300 s timeout), both meshes at once. A rank lays the
parameters out by the reference's parameter rules and the batch by the
cells' specs, and runs each case (that file's docstring) as the dry
run's stage 3 runs a step, under the reference's rule sets. Over
(1, 4) the three uneven-head classes of the production cells occur: 6
heads over 4 ranks (colbertv2's 12 over 16), 2 kv heads over 4 in
decode (8 over 16), 10 heads over 4 with ``attn_shard="sequence"``
(Qwen2.5-14B's 40 over 16).

Held: every output of every rank (its ``full_tensor()``: prefill and
decode logits, the cache, the train loss and every gradient, ColBERT's
doc vectors, DimeNet's loss and gradients, dlrm-rm2's serve logits,
loss and gradients) equal to the same case on one process to 1e-5
relative (Frobenius; sums over ranks in another order); integer
outputs and dlrm-rm2's embedding bags (the row-sharded gather: each row
non-zero on one rank only) equal bit for bit. The one-process results of the GQA case (prefill logits,
the train loss) and of dlrm-rm2 (serve logits, loss) equal the JAX
package's on the same numpy weights (``params_to_jax``) to 1e-5
relative (Frobenius).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_shard_ranks as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "tests")
MESHES = ((2, 2), (1, 4))
REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> ({case: one-process outputs}, {mesh: [per-rank outputs]})."""
    tmp = tmp_path_factory.mktemp("shard")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for d, m in MESHES:
        out = tmp / f"{d}x{m}"
        out.mkdir()
        procs[(d, m)] = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_shard_ranks.py"),
             str(out), str(r), "4", str(out / "store"), str(d), str(m)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT) for r in range(4)]
    single = {case: R.run_case(case) for case in R.CASES}
    ranks = {}
    for mesh, ps in procs.items():
        logs = []
        for p in ps:
            try:
                logs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
        assert all(p.returncode == 0 for p in ps), "\n".join(
            log[-3000:] for log in logs)
        d, m = mesh
        ranks[mesh] = [dict(np.load(tmp / f"{d}x{m}" / f"rank{r}.npz"))
                       for r in range(4)]
    return single, ranks


@pytest.mark.parametrize("case", R.CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_equals_one_process(runs, mesh, case):
    single, ranks = runs
    want = single[case]
    for out in ranks[mesh]:
        got = {k.split("/", 1)[1]: v for k, v in out.items()
               if k.startswith(case + "/")}
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            if not np.issubdtype(w.dtype, np.floating) or k == "bags":
                assert np.array_equal(got[k], w), k
            else:
                assert _rel(got[k], w) <= REL, (k, _rel(got[k], w))


def test_lm_one_process_equals_reference():
    """The GQA case on one process against the JAX package's prefill and
    loss on the same weights."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import transformer as jt
    from repro_torch.models.transformer import init_transformer, params_to_jax
    cfg = R.lm_config("kv2")
    model = init_transformer(cfg, seed=1, device=R.CPU)
    got = R.lm_case("kv2", model=model)
    jc = dataclasses.replace(j_smoke("qwen3-0.6b"), n_layers=1, **R.F32,
                             **R.LM_CASES["kv2"])
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(
        init_transformer(cfg, seed=1, device=R.CPU).state_dict()))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (R.B, R.S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (R.B, R.S)).astype(np.int32)
    hidden, _ = jt.prefill(params, tokens, jc, max_len=R.MAX_LEN)
    logits = jt.logits_head(params, hidden[:, -1:], jc)[:, 0]
    loss, _ = jt.lm_loss(params, tokens, labels, jc)
    assert _rel(got["prefill"], logits) <= REL
    assert _rel(got["loss"], loss) <= REL


def test_dlrm_one_process_equals_reference():
    from repro.configs import get_smoke_config as j_smoke
    from repro.models.recsys import models as jrec
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.recsys.models import init_recsys, params_to_jax
    cfg = dataclasses.replace(get_smoke_config("dlrm-rm2"), **R.F32)
    got = R.dlrm_case()
    jc = dataclasses.replace(j_smoke("dlrm-rm2"), **R.F32)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(
        init_recsys(cfg, seed=7, device=R.CPU).state_dict()))
    batch = jax.tree_util.tree_map(jnp.asarray, R.dlrm_batch(cfg))
    serve = jrec.recsys_forward(params, {k: v for k, v in batch.items()
                                         if k != "label"}, jc)
    loss, _ = jrec.recsys_loss(params, batch, jc)
    assert _rel(got["serve"], serve) <= REL
    assert _rel(got["loss"], loss) <= REL
