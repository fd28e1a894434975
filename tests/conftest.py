import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"


def run_in_subprocess(code: str, device_count: int = 1, timeout: int = 600) -> str:
    """Run a snippet with a forced XLA host device count (kept out of this
    process so the main test session sees exactly 1 device)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={device_count}"
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
        )
    return proc.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skips without one"
    )


@pytest.fixture(scope="session")
def subproc():
    return run_in_subprocess
