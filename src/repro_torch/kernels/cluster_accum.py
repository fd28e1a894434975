"""Fused quantize + per-cell accumulation, and the clustering stage built
on it, in one kernel (CUDA C++, ``csrc/cluster_accum.cu``).

Replaces the TPU kernel ``repro/kernels/cluster_accum.py:cluster_accum``,
the ``use_kernels=True`` route of the clustering stage (the paper's FPGA
IP core fused with the cluster aggregation), and the top-K selection of
``core/grid_clustering.py:clusters_from_histogram`` that followed it. Two
entries launch the one kernel:

* :func:`cluster_accum`, the TPU kernel's own function: the four ``(W,
  n_cells)`` rows count, sum_x, sum_y, sum_t;
* :func:`cluster_accum_topk`, the clustering stage in one launch: the
  ``(W, K)`` :class:`Clusters` of ``clusters_from_histogram`` over those
  rows, with no row written to device memory.

Bound on the H100: bytes. Per window it reads E events of 9 bytes (x, y
int32 + valid bool) and t (4 bytes) of each in-sensor valid event; the
rows entry writes n_cells x 16 bytes (about 19 KB at 1,200 cells, most of
its bound), the stage entry 25 bytes a slot (0.8 KB at K = 32). Design:
one CTA per window keeps the window's cell table in shared memory (about
24 KB), scatters with integer shared-memory atomics (exact in any order,
cast to float32 once); the stage entry then ranks only the cells with
count >= max(min_events, 1) by one block sort of (E - count, cell), the
fixed-point megakernel's method, since slots below ``min_events`` are
constants. The source note in ``csrc/cluster_accum.cu`` has the steps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.grid_clustering import Clusters, GridConfig
from repro_torch.kernels import _build

MAX_EVENTS = 1024  # the block sort's bound, as the megakernel's
MAX_SLOTS = 128

# Each entry's C signature: pointers to x, y, t, valid; its ints; its
# output pointers and the stream.
_ENTRIES = {"cluster_accum_launch": (7, 5), "cluster_accum_topk_launch": (9, 4)}
_fns: dict = {}
_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool)


def _launcher(entry: str):
    if entry not in _fns:
        fn = getattr(_build.load("cluster_accum"), entry)
        n_int, n_ptr = _ENTRIES[entry]
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int + [ctypes.c_void_p] * n_ptr
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _check_events(name: str, x, y, t, valid) -> None:
    """Raise unless x, y, t (int32) and valid (bool) are contiguous ``(W,
    E)`` tensors on one CUDA device."""
    if x.dim() != 2:
        raise ValueError(f"{name} takes (W, E) tensors, got x {tuple(x.shape)}")
    index = x.get_device()
    for a, dt in zip((x, y, t, valid), _DTYPES):
        if a.dtype is not dt:
            raise TypeError(f"{name} takes {dt}, got {a.dtype}")
        if a.shape != x.shape or a.get_device() != index or index < 0 or not a.is_contiguous():
            raise ValueError(
                f"{name} takes contiguous {tuple(x.shape)} tensors on one CUDA device, got "
                f"{tuple(a.shape)} on {a.device}"
            )


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
    """The rows entry, on ``(W, E)`` CUDA tensors: x, y, t int32 and valid
    bool, contiguous. Returns count int32 and sum_x, sum_y, sum_t float32,
    each ``(W, grid_w * grid_h)``."""
    _check_events("cluster_accum", x, y, t, valid)
    w, e = x.shape
    n_cells = grid_w * grid_h
    dev = x.device
    count = torch.empty((w, n_cells), dtype=torch.int32, device=dev)
    sums = [torch.empty((w, n_cells), dtype=torch.float32, device=dev) for _ in range(3)]
    err = _build.launch_on(dev.index, lambda stream: _launcher("cluster_accum_launch")(
        x.data_ptr(), y.data_ptr(), t.data_ptr(), valid.data_ptr(),
        w, e, cell_size, grid_w, grid_h, width, height,
        count.data_ptr(), *(s.data_ptr() for s in sums), stream,
    ))
    _build.check(err, "cluster_accum")
    return (count, *sums)


def cluster_accum_topk(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    grid: GridConfig,
) -> Clusters:
    """The stage entry, on ``(W, E)`` CUDA tensors as :func:`cluster_accum`
    takes them: ``clusters_from_histogram`` of the rows under ``grid``
    (its cells, ``min_events`` and ``max_clusters`` = K), one launch.
    Returns ``(W, K)`` :class:`Clusters`, views of three buffers. Raises
    ``ValueError`` for E > 1024 and for K outside [1, min(128, n_cells)]."""
    _check_events("cluster_accum_topk", x, y, t, valid)
    w, e = x.shape
    k = grid.max_clusters
    grid_w, grid_h = grid.grid_w, grid.grid_h
    if e > MAX_EVENTS:
        raise ValueError(f"E ({e}) exceeds the kernel's bound ({MAX_EVENTS})")
    if not 1 <= k <= min(MAX_SLOTS, grid_w * grid_h):
        raise ValueError(f"max_clusters ({k}) must be in [1, min({MAX_SLOTS}, n_cells)]")
    dev = x.device
    cent = torch.empty((3, w, k), dtype=torch.float32, device=dev)
    ints = torch.empty((3, w, k), dtype=torch.int32, device=dev)
    cvalid = torch.empty((w, k), dtype=torch.bool, device=dev)
    err = _build.launch_on(dev.index, lambda stream: _launcher("cluster_accum_topk_launch")(
        x.data_ptr(), y.data_ptr(), t.data_ptr(), valid.data_ptr(),
        w, e, grid.cell_size, grid_w, grid_h, grid.width, grid.height, grid.min_events, k,
        cent.data_ptr(), ints.data_ptr(), cvalid.data_ptr(), stream,
    ))
    _build.check(err, "cluster_accum_topk")
    return Clusters(*cent.unbind(0), *ints.unbind(0), cvalid)
