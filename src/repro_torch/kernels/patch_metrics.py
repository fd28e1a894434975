"""The metrics stage in one kernel launch (CUDA C++,
``csrc/patch_metrics.cu``).

Replaces the TPU kernel ``repro/kernels/patch_metrics.py:patch_metrics``,
the ``metrics_impl="kernel"`` route of the metrics stage, together with
the event-space preprocessing around it (``core/metrics.py``'s
``event_normalizer``, a pairwise coincidence pass, and ``window_origin``):
a block's conditioned events and its cluster slots in, the six metrics of
every slot out.

Two paths, picked at launch from the sizes. The small path (E <= 1024, K
<= 128, the main path's blocks with 1-2 valid slots a busy window) is
bound by bytes: of each window that holds a valid slot, the valid flag of
every event slot and x and y of each valid event, and 24 bytes out a
slot. One CTA per window; it sorts the
in-sensor events by (pixel, index) once in registers, reads coincidence
counts, leaders and the normalizer off the pixel runs (no (E, E) pass),
then runs its valid slots one after another.

The large path takes any E and any K. On fixed-time windows nearly every
slot is valid (the scale recording's 100 ms stride windows: 4,096 events,
31.75 of 32 slots), and counted over every pixel of every slot the stage
is bound by operations, not bytes; counting only the work the function
needs (the Sobel near occupied pixels, no sort) it is bound by bytes.
Its design: a few CTAs a window, 8-32 slots each (by the grid's size), a
valid slot a warp in its own patch table, so a window's slots run side by
side; each CTA indexes the window's events by sensor row (a count, a scan
and a scatter, no sort), so a slot reads only the events of its 48 rows;
the normalizer comes from counts within each row; the Sobel runs only at
pixels next to an occupied one, dealt evenly over the lanes, the rest
entering the sums as one product. Past shared memory (E above 65,535) the
row index and the events' x go to per-CTA scratch in device memory, which
the wrapper allocates at the size the library asks for. The source note
in ``csrc/patch_metrics.cu`` has the steps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import metrics as M
from repro_torch.kernels import _build

WINDOW = 48  # compiled into the kernel
BINS = 32

_fns: dict = {}
_scratch_bytes: dict = {}  # (device, sizes) -> bytes a window
_EVENT_DTYPES = (torch.int32, torch.int32, torch.bool)
_SLOT_DTYPES = (torch.float32, torch.float32, torch.int32, torch.bool)


def _launcher():
    if not _fns:
        lib = _build.load("patch_metrics")
        fn = lib.patch_metrics_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        q = lib.patch_metrics_scratch_bytes
        q.argtypes = [ctypes.c_int] * 6
        q.restype = ctypes.c_longlong
        _fns.update(launch=fn, scratch=q)
    return _fns["launch"]


def patch_metrics(batch, clusters, *, width: int, height: int) -> dict[str, torch.Tensor]:
    """Launch on CUDA tensors of one device, as the window core hands them
    over, contiguous: ``batch.x``, ``batch.y`` ``(W, E)`` int32 and
    ``batch.valid`` bool; ``clusters.centroid_x``/``centroid_y`` ``(W, K)``
    float32, ``count`` int32, ``valid`` bool. Returns the metric dict keyed
    by ``METRIC_NAMES``, each ``(W, K)`` float32, views of one buffer.
    Raises ``TypeError`` for another dtype and ``ValueError`` for another
    layout; takes any E and any K."""
    return _launch(batch, clusters, width, height, 0)


def _launch(batch, clusters, width: int, height: int, group: int) -> dict[str, torch.Tensor]:
    """:func:`patch_metrics` with the large path's slots a CTA set to
    ``group`` (1-32; 0 or another value: the library picks 32, 16 or 8 from
    the grid's size). For tests and tools; the small path ignores it."""
    events = (batch.x, batch.y, batch.valid)
    slots = (clusters.centroid_x, clusters.centroid_y, clusters.count, clusters.valid)
    x = batch.x
    if x.dim() != 2 or clusters.valid.dim() != 2:
        raise ValueError("patch_metrics takes (W, E) events and (W, K) slots")
    n_win, e = x.shape
    k = clusters.valid.shape[1]
    index = x.get_device()
    for tensors, dtypes, shape in ((events, _EVENT_DTYPES, (n_win, e)), (slots, _SLOT_DTYPES, (n_win, k))):
        for a, dt in zip(tensors, dtypes):
            if a.dtype is not dt:
                raise TypeError(f"patch_metrics takes {dt}, got {a.dtype}")
            if a.shape != shape or a.get_device() != index or index < 0 or not a.is_contiguous():
                raise ValueError(
                    f"patch_metrics takes contiguous {shape} tensors on one CUDA device, got "
                    f"{tuple(a.shape)} on {a.device}"
                )
    out = torch.empty((len(M.METRIC_NAMES), n_win, k), dtype=torch.float32, device=x.device)
    launch = _launcher()
    key = (index, n_win, e, k, width, height, group)
    per = _scratch_bytes.get(key)
    if per is None:  # asked once per device and sizes
        per = _scratch_bytes[key] = _build.launch_on(
            index, lambda _stream: _fns["scratch"](n_win, e, k, width, height, group))
    scratch = (torch.empty(n_win * per, dtype=torch.uint8, device=x.device)
               if per and n_win and k else None)
    err = _build.launch_on(index, lambda stream: launch(
        *(a.data_ptr() for a in events + slots), n_win, e, k, width, height, group,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), stream,
    ))
    _build.check(err, "patch_metrics")
    return dict(zip(M.METRIC_NAMES, out.unbind(0)))
