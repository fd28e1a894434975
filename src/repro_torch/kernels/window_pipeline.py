"""The fixed-point per-window chain in one kernel launch (CUDA C++).

Replaces the TPU kernel ``repro/kernels/window_pipeline.py:window_pipeline``,
the ``numerics="fixed", metrics_impl="megakernel"`` route: conditioning,
coincidence counts, the integer cell histogram, top-K, UQ10.8 centroids
and patch origins, and per valid slot the patch, histogram, integer Sobel
and moment sums, for a whole block of windows.

Bound on the H100, by what the function needs: about 0.005 ms of bytes
(events in; fields, norm and valid-slot surfaces out) and 0.007 ms of
32-bit integer work, mostly the Sobel and sums of each valid slot's
patch, at the main path's block of 4,096 windows of 256 events. Design:
one CTA per window keeps the window's events, two sort buffers and one
48x48 patch in shared memory. One block-wide sort of the kept events by
(cell, pixel, index) gives the hot-pixel verdicts, coincidence counts and
leaders from its pixel runs and the cell sums from its cell runs, with
no pairwise pass and no cell table; one sort of the counted cells gives
the top-K slots, since slots below ``min_events`` are constants; then
each valid slot's patch, histogram, integer Sobel and moments. Only the
compact integer outputs are written; the float epilogue runs after it in
:func:`repro_torch.core.fixed_point.fixed_metric_epilogue`, shared with
the staged path. The source note in ``csrc/window_pipeline.cu`` has the
steps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

WINDOW = 48  # compiled into the kernel
BINS = 32
MAX_EVENTS = 1024  # the reference's contract (its pairwise block bound)
MAX_SLOTS = 128
CL_FIELDS = ("count", "cell_x", "cell_y", "cq_x", "cq_y", "cq_t", "x0", "y0", "valid")

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("window_pipeline").window_pipeline_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def window_pipeline(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    valid: torch.Tensor,
    *,
    roi: tuple[int, int, int, int],
    hot_pixel_max: int,
    cell_size: int,
    grid_w: int,
    grid_h: int,
    min_events: int,
    k: int,
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch on ``(W, E)`` CUDA tensors: x, y, t int32 and valid bool,
    contiguous. Returns the fields ``(W, 9, K)`` int32 in ``CL_FIELDS``
    order, the normalizer ``(W,)`` int32 and the surfaces ``(W, K,
    BINS + 5)`` int32 (histogram, then s1, s2, s_g, s_e2, edges; zero for
    invalid slots)."""
    if x.dim() != 2 or any(a.shape != x.shape for a in (y, t, valid)):
        raise ValueError(f"window_pipeline takes four (W, E) tensors, got x {tuple(x.shape)}")
    for a, dt in ((x, torch.int32), (y, torch.int32), (t, torch.int32), (valid, torch.bool)):
        if a.device.type != "cuda" or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"window_pipeline takes contiguous CUDA {dt}, got {a.dtype} on {a.device}")
    w, e = x.shape
    dev = x.device
    fields = torch.empty((w, len(CL_FIELDS), k), dtype=torch.int32, device=dev)
    norm = torch.empty((w,), dtype=torch.int32, device=dev)
    surf = torch.empty((w, k, BINS + 5), dtype=torch.int32, device=dev)
    err = _build.launch_on(dev.index, lambda stream: _launcher()(
        x.data_ptr(), y.data_ptr(), t.data_ptr(), valid.data_ptr(),
        w, e, *roi, hot_pixel_max, cell_size, grid_w, grid_h, min_events, k,
        width, height, fields.data_ptr(), norm.data_ptr(), surf.data_ptr(), stream,
    ))
    _build.check(err, "window_pipeline")
    return fields, norm, surf
