"""Training over a mesh on gloo ranks (``Trainer(mesh=...)``, the
checkpoint's elastic restore, the driver under ``torchrun``), held to
the port's one-process trainer and to the JAX package's ``Trainer``
without a mesh.

The jobs of ``tests/torch_train_ranks.py`` (its docstring) start at
once, each rank a process (a ``FileStore`` rendezvous, one thread, a
300 s timeout): ``host`` (four ranks of the host mesh: Qwen3 and Kimi
K2 SMOKE in f32), ``2x2`` (Qwen3 over a (2, 2) ``("data", "model")``
mesh, then the non-finite skip), ``fail`` (four ranks, rank 1
raising at step 4), then ``resume`` (two ranks, from the ``fail`` job's
step-3 checkpoint). Beside them, the driver under ``python -m
torch.distributed.run --nproc-per-node 2`` (``--smoke --device cpu``)
and on one process.

Held:
* every rank's losses and full parameters equal to the one-process
  trainer's to 1e-5 relative (Frobenius; sums over ranks in another
  order: at worst 6.1e-6 on a CPU with torch 2.13, a norm scale's Adam
  update), its optimizer state to 1e-4 (the moments carry six steps'
  gradients summed in another order: at worst 3.8e-5), the state laid
  out as the reference's specs say (AdamW's moments as their parameter,
  Adafactor's factored rows and columns with the averaged dim's axis
  dropped);
* the Qwen3 runs against the JAX ``Trainer`` without a mesh on the
  same weights and batches, at ``tests/test_torch_lm_train.py``'s
  tolerance (losses rtol 1e-5 / atol 1e-6; parameters rtol 1e-4 /
  atol 1e-6 but on 0.1% of a tensor's elements, which stay within a
  tenth of the learning rate);
* the four ranks' checkpoints: only rank 0's trees hold host arrays
  (the others gather each leaf and drop it);
* the four ranks' step-3 checkpoint: the same paths, shapes and dtypes
  as the one-process trainer's, restored on two ranks (through
  ``restore(placements=...)``), on one process and by the JAX package's
  ``CheckpointManager``, each trained on to step 6 with the
  uninterrupted run's losses to 1e-5 relative;
* the poisoned step's parameters and state unchanged bit for bit on
  every rank, its step count too, and the run after it equal to the
  one-process run's;
* the failing job: all four processes exit non-zero within 120 s;
* the driver: exit 0, the mesh line printed, and the printed losses and
  the checkpoint within bf16's reach of the one-process driver's: the
  SMOKE config computes in bf16, so the ranks' other order of sums
  moves a rounding after the first update (seen: losses 6e-5 relative,
  parameters 2.1e-4, the moments 1.1e-2); the f32 agreement over ranks
  is held to 1e-5 by the trainer's runs above.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_train_ranks as R

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
HERE = os.path.join(ROOT, "tests")
REL = 1e-5
STATE_REL = 1e-4          # moments: gradients summed over ranks, 6 steps
LOSS = dict(rtol=1e-5, atol=1e-6)             # test_torch_lm_train.py's
GRAD = dict(rtol=1e-4, atol=1e-6)
JOBS = {"host": 4, "2x2": 4, "fail": 4}
CASES = {"qwen3_host": ("host", "qwen3"), "qwen3_2x2": ("2x2", "qwen3"),
         "kimi_host": ("host", "kimi")}
DRIVER = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
          "--seq", "16", "--microbatches", "2"]
BF16_LOSS = 2.0 ** -8         # one bf16 step, relative
BF16_PARAMS = 1e-3            # 3 steps of lr 3e-4 on f32 parameters
BF16_STATE = 2.0 ** -5        # the moments: bf16 gradients
FAIL_LIMIT_S = 120.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.path.join(ROOT, "src"))


def _start(job, out, world):
    out.mkdir(exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_train_ranks.py"), job,
         str(out), str(r), str(world), str(out / f"store_{job}")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=ROOT) for r in range(world)]


def _finish(ps, timeout=300):
    """-> (return codes, logs, seconds until the last exited)."""
    t0, logs = time.monotonic(), []
    for p in ps:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in ps:
                q.kill()
            raise
    return [p.returncode for p in ps], logs, time.monotonic() - t0


def _ranks(out, world):
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _part(res, name):
    return {k.split("/", 1)[1]: v for k, v in res.items()
            if k.startswith(name + "/")}


def _tree(res):
    return {k[len("tree/"):]: v for k, v in res.items()
            if k.startswith("tree/")}


def _one_process(ckpt):
    """The one-process runs: Qwen3 (checkpoints in ``ckpt``), Kimi, the
    skip run."""
    return {"qwen3": R.train("qwen3-0.6b", ckpt=ckpt),
            "kimi": R.train("kimi-k2-1t-a32b"), "skip": R.skip()}


def _jax_trainer():
    """The JAX ``Trainer`` without a mesh on the port's seed-0 Qwen3
    weights, and its loss."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import transformer as jtr
    from repro.train.trainer import TrainConfig as JTrainConfig
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.models.transformer import init_transformer, params_to_jax
    import dataclasses
    jc = dataclasses.replace(j_smoke("qwen3-0.6b"), dtype="float32",
                             param_dtype="float32")
    model = init_transformer(R.lm_config("qwen3-0.6b"), seed=0,
                             device=R.CPU)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    params_to_jax(model.state_dict()))

    def loss_fn(p, b):
        return jtr.lm_loss(p, b["tokens"], b["labels"], jc,
                           loss_mask=b["mask"])

    return JTrainer(loss_fn, params, JTrainConfig(
        total_steps=R.STEPS, microbatches=R.MICRO, log_every=1, lr=R.LR,
        warmup=R.WARMUP, optimizer="adamw"))


def _jax_run():
    """The JAX trainer (its step compiled) after its 6 uninterrupted
    steps, their losses and parameters."""
    jt = _jax_trainer()
    full = jt.run(R.batches(R.lm_config("qwen3-0.6b")))
    return jt, {"losses": np.array([h["loss"] for h in full["history"]]),
                "params": jax.tree_util.tree_map(np.asarray, jt.params)}


def _jax_resume(jt, out, ckpt):
    """The 4-rank step-3 checkpoint restored by the JAX package and
    trained on to 6 by ``jt``."""
    from repro.train.checkpoint import CheckpointManager as JCheckpointManager
    cfg = R.lm_config("qwen3-0.6b")
    step, tree, _ = JCheckpointManager(ckpt).restore(R.EVERY)
    jt.params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    jt.opt_state = jax.tree_util.tree_map(jnp.asarray, tree["opt_state"])
    jt.step = step
    again = jt.run(R.batches(cfg, start_step=step))
    out["resumed"] = np.array([h["loss"] for h in again["history"]])
    return out


def _one_process_resume(ckpt):
    """The 4-rank step-3 checkpoint restored by the one-process trainer
    and trained on to 6."""
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.params import load_tree
    from repro_torch.train.trainer import load_state_tree
    t, cfg = R.trainer("qwen3-0.6b")
    step, tree, _ = CheckpointManager(ckpt).restore(R.EVERY)
    load_tree(t.params, tree["params"])
    t.opt_state = load_state_tree(t.opt_state, tree["opt_state"])
    t.step = step
    return R.losses(t.run(R.batches(cfg, start_step=step)))


def _driver_losses(text):
    return [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("step ")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ranks")
    started = []
    try:
        yield _runs(tmp, started)
    finally:                         # nothing outlives the module
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait()


def _runs(tmp, started):
    import contextlib
    import io
    from repro_torch.launch import train as ttrain
    from repro_torch.train.checkpoint import CheckpointManager
    procs = {job: _start(job, tmp / job, n) for job, n in JOBS.items()}
    (tmp / "drv2").mkdir()
    driver = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *DRIVER, "--checkpoint-dir", str(tmp / "drv2")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={k: v for k, v in _env().items() if k not in (
            "WORLD_SIZE", "RANK", "LOCAL_RANK")}, cwd=ROOT)
    started += [p for ps in procs.values() for p in ps] + [driver]
    fail = _finish(procs.pop("fail"))
    resume = _start("resume", tmp / "fail", 2)
    started += resume
    single = _one_process(str(tmp / "single"))
    jt, jax_out = _jax_run()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ttrain.main(DRIVER + ["--checkpoint-dir",
                                     str(tmp / "drv1")]) == 0
    ranks = {}
    for job, ps in procs.items():
        codes, logs, _ = _finish(ps)
        assert codes == [0] * len(ps), "\n".join(x[-3000:] for x in logs)
        ranks[job] = _ranks(tmp / job, len(ps))
    host_ckpt = str(tmp / "host" / "ckpt")
    jax_out = _jax_resume(jt, jax_out, host_ckpt)
    one_resumed = _one_process_resume(host_ckpt)
    codes, logs, _ = _finish(resume)
    assert codes == [0, 0], "\n".join(x[-3000:] for x in logs)
    ranks["resume"] = _ranks(tmp / "fail", 2)
    drv_log = driver.communicate(timeout=300)[0]
    mgr = {n: CheckpointManager(str(tmp / n)) for n in ("drv1", "drv2")}
    return dict(
        single=single, ranks=ranks, fail=fail, jax=jax_out,
        one_resumed=one_resumed,
        ckpts={"single": str(tmp / "single"), "host": host_ckpt,
               "fail": str(tmp / "fail" / "ckpt")},
        driver=(driver.returncode, drv_log, buf.getvalue(),
                {n: m.restore()[1] for n, m in mgr.items()}))


@pytest.mark.parametrize("case", CASES)
def test_mesh_run_equals_one_process(runs, case):
    job, name = CASES[case]
    want = runs["single"][name]
    for res in runs["ranks"][job]:
        got = _part(res, name)
        assert bool(got["laid_out"]), "state not laid out as its specs"
        assert _rel(got["losses"], want["losses"]) <= REL
        gt, wt = _tree(got), _tree(want)
        assert sorted(gt) == sorted(wt)
        for k, w in wt.items():
            assert gt[k].shape == w.shape and gt[k].dtype == w.dtype, k
            tol = REL if k.startswith("params/") else STATE_REL
            assert _rel(gt[k], w) <= tol, (k, _rel(gt[k], w))


def _close_step(got, want, lr):
    d = np.abs(got - want)
    off = d > GRAD["atol"] + GRAD["rtol"] * np.abs(want)
    return off.mean() <= 1e-3 and d.max() <= lr / 10


@pytest.mark.parametrize("case", ["qwen3_host", "qwen3_2x2"])
def test_mesh_run_matches_jax_trainer(runs, case):
    from repro_torch.train.params import tree_paths
    job, name = CASES[case]
    want = runs["jax"]
    jparams = dict(tree_paths(want["params"]))
    for res in runs["ranks"][job]:
        got = _part(res, name)
        np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
        params = {k[len("params/"):]: v for k, v in _tree(got).items()
                  if k.startswith("params/")}
        assert sorted(params) == sorted(jparams)
        for k, w in jparams.items():
            assert _close_step(params[k], w, R.LR), k


def _manifest(ckpt, step):
    import json
    with open(os.path.join(ckpt, f"step_{step}", "manifest.json")) as f:
        return {p: (e["shape"], e["dtype"])
                for p, e in json.load(f)["entries"].items()}


@pytest.mark.parametrize("where", ["two_ranks", "one_process", "jax"])
def test_four_rank_checkpoint_restores_elsewhere(runs, where):
    """Written by four ranks at step 3: the one-process layout, and each
    reader trains on to the uninterrupted run's losses."""
    c = runs["ckpts"]
    want = _manifest(c["single"], R.EVERY)
    assert _manifest(c["host"], R.EVERY) == want
    assert _manifest(c["fail"], R.EVERY) == want
    tail = runs["single"]["qwen3"]["losses"][R.EVERY:]
    if where == "two_ranks":
        for res in runs["ranks"]["resume"]:
            got = _part(res, "resume")
            assert int(got["start"]) == R.EVERY
            assert bool(got["restore_laid_out"])
            assert _rel(got["losses"], tail) <= REL
            full = _tree(runs["single"]["qwen3"])
            for k, v in _tree(got).items():
                tol = REL if k.startswith("params/") else STATE_REL
                assert _rel(v, full[k]) <= tol, k
    elif where == "one_process":
        assert _rel(runs["one_resumed"], tail) <= REL
    else:
        assert _rel(runs["jax"]["resumed"], tail) <= REL


def test_nonfinite_step_skipped_bitwise_on_every_rank(runs):
    want = runs["single"]["skip"]
    assert bool(want["kept"])
    bad = R.POISON - 1
    for res in runs["ranks"]["2x2"]:
        got = _part(res, "skip")
        assert bool(got["kept"])
        assert np.isnan(got["losses"][bad]) and np.isnan(want["losses"][bad])
        keep = np.arange(len(want["losses"])) != bad
        assert _rel(got["losses"][keep], want["losses"][keep]) <= REL
        for k, w in _tree(want).items():
            tol = REL if k.startswith("params/") else STATE_REL
            assert _rel(_tree(got)[k], w) <= tol, k


def test_failure_on_one_rank_stops_every_rank(runs):
    codes, logs, seconds = runs["fail"]
    assert all(c != 0 for c in codes), codes
    assert seconds <= FAIL_LIMIT_S, seconds
    assert "PlantedFailure" in logs[1]
    # the relaunch on two ranks resumed from the last checkpoint
    for res in runs["ranks"]["resume"]:
        assert int(res["resume/start"]) == R.EVERY


def test_driver_under_torchrun(runs):
    from repro_torch.train.params import tree_paths
    code, log, one, trees = runs["driver"]
    assert code == 0, log[-3000:]
    assert "mesh {'data': 2} over 2 ranks (cpu)" in log
    got, want = _driver_losses(log), _driver_losses(one)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS, atol=0)
    g, w = dict(tree_paths(trees["drv2"])), dict(tree_paths(trees["drv1"]))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        if np.issubdtype(w[k].dtype, np.floating):
            tol = BF16_PARAMS if k.startswith("params/") else BF16_STATE
            assert _rel(g[k], w[k]) <= tol, (k, _rel(g[k], w[k]))
        else:
            assert np.array_equal(g[k], w[k]), k


def test_only_rank0_keeps_checkpoint_arrays(runs):
    """Every rank takes part in each save's gathers; only rank 0's tree
    holds host arrays (all of the checkpoint's float leaves), the
    others none."""
    n_leaves = len([k for k in _tree(runs["single"]["qwen3"])
                    if k != "opt_state/step"])
    for rank, res in enumerate(runs["ranks"]["host"]):
        seen = _part(res, "qwen3")["saved_arrays"]
        assert len(seen) == 3, seen          # steps 3 and 6, the final
        assert list(seen) == [n_leaves if rank == 0 else 0] * 3, (
            rank, seen)


def test_host_mesh_rules_name_no_model_axis():
    """On a mesh without ``model`` the rules map it to no axis; a mesh
    with one keeps the tables unchanged."""
    from repro_torch.sharding.api import lm_rules, retrieval_rules
    from repro_torch.sharding.params import lm_param_rules
    r = lm_rules("data", None)
    assert r["heads"] is None and r["batch"] == "data"
    assert retrieval_rules("data", None)["docs"] == "data"
    assert retrieval_rules(("pod", "data"), None)["docs"] == ("pod", "data")
    assert retrieval_rules("data")["docs"] == ("data", "model")
    assert dict(lm_param_rules("data", None))[r"attn/wq/w$"] == (
        "data", None)
    assert lm_rules("data") == lm_rules("data", "model")
