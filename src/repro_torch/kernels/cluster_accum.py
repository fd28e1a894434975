"""Fused quantize + per-cell count/sum_x/sum_y/sum_t kernel (CUDA C++).

Replaces the TPU kernel ``repro/kernels/cluster_accum.py:cluster_accum``,
the ``use_kernels=True`` route of the clustering stage (the paper's FPGA
IP core fused with the cluster aggregation).

Bound on the H100: memory. Per window it reads E events of 9 bytes
(x, y int32 + valid bool), t (4 bytes) of each in-sensor valid event,
and writes n_cells x 16 bytes (count int32 + three float32 sums); at the
pipeline's shapes (E = 256, 1200 cells) the write is about 6x the read,
and the arithmetic is a few integer operations per event. Design: one CTA per window keeps the window's 1200 x 4
counters in shared memory (about 24 KB), scatters with shared-memory
atomics in integers (exact in any order, cast to float32 once) and
writes each output row once, coalesced; device memory sees nothing but
the one read of the inputs and the one write of the outputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("cluster_accum").cluster_accum_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cluster_accum(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    *,
    cell_size: int,
    grid_w: int,
    grid_h: int,
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch on ``(W, E)`` CUDA tensors: x, y, t int32 and valid bool,
    contiguous. Returns count int32 and sum_x, sum_y, sum_t float32, each
    ``(W, grid_w * grid_h)``."""
    if x.dim() != 2 or any(a.shape != x.shape for a in (y, t, valid)):
        raise ValueError(f"cluster_accum takes four (W, E) tensors, got x {tuple(x.shape)}")
    for a, dt in ((x, torch.int32), (y, torch.int32), (t, torch.int32), (valid, torch.bool)):
        if a.device.type != "cuda" or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"cluster_accum takes contiguous CUDA {dt}, got {a.dtype} on {a.device}")
    w, e = x.shape
    n_cells = grid_w * grid_h
    dev = x.device
    count = torch.empty((w, n_cells), dtype=torch.int32, device=dev)
    sums = [torch.empty((w, n_cells), dtype=torch.float32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        err = _launcher()(
            x.data_ptr(), y.data_ptr(), t.data_ptr(), valid.data_ptr(),
            w, e, cell_size, grid_w, grid_h, width, height,
            count.data_ptr(), *(s.data_ptr() for s in sums),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "cluster_accum")
    return (count, *sums)
