"""``perfbench/run.py`` as a process: it refuses to run without a card or
without the program, and what it loads holds no module of JAX or of the
JAX package (top-level names compared whole: ``repro_torch`` is the
port, ``repro`` the JAX package)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RUN = [sys.executable, "perfbench/run.py", "--workload", "archive.suite", "--seed", "3", "--seconds", "1"]


def _env(**extra) -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"))
    env.update(extra)
    return env


def test_refuses_without_a_card():
    proc = subprocess.run(RUN, cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(RUN, cwd=tmp_path, env=_env(PYTHONPATH=""), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "repro_torch" in proc.stderr


def test_module_check_finds_no_jax_after_a_run():
    code = """
import json, sys, time
sys.path.insert(0, "perfbench")
import run  # the entry point's imports
from harness import bench
tiny = dict(count=2, duration_s=0.3, noise_rate_hz=3500.0, n_rsos=[2], lenses=["standard"],
            warmup_passes=1, trace_units=1)
out = bench.run_cell("archive.suite", 5, 0.2, False, time.perf_counter(), device="cpu", traffic=tiny)
mods = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps(dict(correct=out["correct"], found=bench.loaded_forbidden(), mods=mods)))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["found"] == []
    assert "repro_torch" in got["mods"] and not {"jax", "jaxlib", "flax", "repro"} & set(got["mods"])


def test_module_check_compares_whole_top_level_names():
    code = """
import sys, types
sys.path.insert(0, "perfbench")
from harness import bench
sys.modules["repro_torchlike"] = types.ModuleType("repro_torchlike")
assert bench.loaded_forbidden() == []
sys.modules["repro.core"] = types.ModuleType("repro.core")
assert bench.loaded_forbidden() == ["repro"]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of the fleet cell on the card comes out correct.

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/test_perfbench_process.py
    """
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, "perfbench/run.py", "--workload", "fleet18.suite", "--seed", "11",
           "--seconds", "3"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
