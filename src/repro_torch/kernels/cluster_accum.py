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
constants. At E <= 1024 and K <= 128 (the main path) the keys are sorted
in registers; past either the kernel's large path sorts 64-bit keys in
memory and strides over the slots, so no E and no K <= n_cells is
refused. Where a window's table and keys outgrow shared memory (cells of
a few pixels) they go to per-window scratch in device memory, which the
wrapper allocates at the size the library asks for. The source note in
``csrc/cluster_accum.cu`` has the steps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.grid_clustering import Clusters, GridConfig
from repro_torch.kernels import _build

# Each entry's C signature: pointers to x, y, t, valid; its ints; its
# output pointers, the scratch and the stream.
_ENTRIES = {"cluster_accum_launch": (7, 6), "cluster_accum_topk_launch": (9, 5)}
_fns: dict = {}
_scratch_bytes: dict = {}  # (device, sizes) -> bytes a window
_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool)


def _launcher(entry: str):
    if entry not in _fns:
        lib = _build.load("cluster_accum")
        fn = getattr(lib, entry)
        n_int, n_ptr = _ENTRIES[entry]
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int + [ctypes.c_void_p] * n_ptr
        fn.restype = ctypes.c_int
        _fns[entry] = fn
        if "scratch" not in _fns:
            q = lib.cluster_accum_scratch_bytes
            q.argtypes = [ctypes.c_int] * 7
            q.restype = ctypes.c_longlong
            _fns["scratch"] = q
    return _fns[entry]


def _scratch(n_win: int, e: int, cell_size: int, grid_w: int, grid_h: int, min_events: int,
             k: int, topk: bool, device) -> torch.Tensor | None:
    """The per-window device scratch the library asks for at these sizes
    (``None`` where it needs none: the table fits in shared memory). The
    library is asked once per device and sizes, so a call at sizes seen
    before makes no foreign call for it."""
    key = (device.index, e, cell_size, grid_w, grid_h, min_events, k, topk)
    per = _scratch_bytes.get(key)
    if per is None:
        per = _scratch_bytes[key] = _build.launch_on(device.index, lambda _stream: (
            _fns["scratch"](e, cell_size, grid_w, grid_h, min_events, k, int(topk))))
    if per == 0 or n_win == 0:
        return None
    return torch.empty(n_win * per, dtype=torch.uint8, device=device)


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
    launch = _launcher("cluster_accum_launch")
    scratch = _scratch(w, e, cell_size, grid_w, grid_h, 0, 1, False, dev)
    err = _build.launch_on(dev.index, lambda stream: launch(
        x.data_ptr(), y.data_ptr(), t.data_ptr(), valid.data_ptr(),
        w, e, cell_size, grid_w, grid_h, width, height,
        count.data_ptr(), *(s.data_ptr() for s in sums),
        None if scratch is None else scratch.data_ptr(), stream,
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
    Returns ``(W, K)`` :class:`Clusters`, views of three buffers. Takes
    any E; raises ``ValueError`` for K outside [1, n_cells], which
    ``top_k`` refuses too."""
    _check_events("cluster_accum_topk", x, y, t, valid)
    w, e = x.shape
    k = grid.max_clusters
    grid_w, grid_h = grid.grid_w, grid.grid_h
    if not 1 <= k <= grid_w * grid_h:
        raise ValueError(f"max_clusters ({k}) must be in [1, n_cells = {grid_w * grid_h}]")
    dev = x.device
    cent = torch.empty((3, w, k), dtype=torch.float32, device=dev)
    ints = torch.empty((3, w, k), dtype=torch.int32, device=dev)
    cvalid = torch.empty((w, k), dtype=torch.bool, device=dev)
    launch = _launcher("cluster_accum_topk_launch")
    scratch = _scratch(w, e, grid.cell_size, grid_w, grid_h, grid.min_events, k, True, dev)
    err = _build.launch_on(dev.index, lambda stream: launch(
        x.data_ptr(), y.data_ptr(), t.data_ptr(), valid.data_ptr(),
        w, e, grid.cell_size, grid_w, grid_h, grid.width, grid.height, grid.min_events, k,
        cent.data_ptr(), ints.data_ptr(), cvalid.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stream,
    ))
    _build.check(err, "cluster_accum_topk")
    return Clusters(*cent.unbind(0), *ints.unbind(0), cvalid)
