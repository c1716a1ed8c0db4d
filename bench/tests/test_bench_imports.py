"""What the harness and the reference import, in fresh processes."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_SMOKE = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from bench.run import run_cell
from bench.smoke import smoke_spec
spec = smoke_spec("jacolbertv2.search-batch")
spec["work_dir"] = {work!r}
run_cell(spec, 3, 0.2, True, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

IMPORT_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import bench.reference.check, bench.reference.encoder, bench.reference.index
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax_nor_the_jax_package(tmp_path):
    names = _top_level(RUN_SMOKE.format(src=str(ROOT / "src"),
                                        root=str(ROOT),
                                        work=str(tmp_path / "work")))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    names = _top_level(IMPORT_REFERENCE.format(root=str(ROOT)))
    assert "torch" in names
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "colbertv2.build", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
