"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds, and no ``ninja``. The ``csrc/*.cuh``
headers hold device code that several sources include. All sources are
compiled in parallel at first use, into ``build/repro_torch/<hash>/``
under the checkout, where ``<hash>`` covers the sources, the headers and
the flags, so an edited file builds anew and an unchanged one is
reused. Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = (
    "cluster_accum", "patch_metrics", "window_pipeline",
    "event_unpack", "grid_quantize", "window_entropy",
)
# sm_90a: Hopper with its architecture-specific features. No fast math:
# division and sqrt stay IEEE, which the metric kernel relies on.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source not yet built, all ``nvcc`` runs at once.
    Returns the library path of each kernel; raises with the compiler's
    output when a build fails. ``ptxas -v`` reports go to ``<name>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [name for name in SOURCES if not libs[name].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _libs:
        path = build_all()[name]
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def launch_on(index: int, launch: Callable[[int], int]) -> int:
    """Call ``launch(stream)`` with the raw current stream of CUDA device
    ``index`` (``torch.cuda.current_stream()`` builds a Stream object,
    several times the cost of a launch), that device made current only if
    it is not already. Returns what ``launch`` returns."""
    import torch

    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return launch(stream)
    with torch.cuda.device(index):
        return launch(stream)


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
