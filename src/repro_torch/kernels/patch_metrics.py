"""The metrics stage in one kernel launch (CUDA C++,
``csrc/patch_metrics.cu``).

Replaces the TPU kernel ``repro/kernels/patch_metrics.py:patch_metrics``,
the ``metrics_impl="kernel"`` route of the metrics stage, together with
the event-space preprocessing around it (``core/metrics.py``'s
``event_normalizer``, a pairwise coincidence pass, and ``window_origin``):
a block's conditioned events and its cluster slots in, the six metrics of
every slot out.

Bound on the H100: bytes. It reads x, y and valid (9 bytes an event) of
each window that holds a valid slot, the valid flag of every slot and the
centroids and count of each valid slot, and writes 24 bytes a slot; the
float32 work, about 25 operations for each of a valid slot's 2,304
pixels, stays below that at the main path's 1-2 valid slots per busy
window. Design: one CTA per window, none per slot; a window with no valid
slot writes zeros and exits. The CTA loads the window's events once into
shared memory, sorts the in-sensor ones by (pixel, index) once, reads
coincidence counts, leaders and the normalizer off the pixel runs (no
(E, E) pass), then runs its valid slots one after another: patch,
histogram, Sobel and the six metrics, the patch in shared memory and the
per-pixel values in registers. At E <= 1024 and K <= 128 (the main path)
the sort runs in registers; past either the kernel's large path sorts in
memory, finds each run's end by a binary search and strides over the
slots, so no E and no K is refused. Past about 8,000 events a window
(shared memory's 227 KB) the events and keys go to per-window scratch in
device memory, which the wrapper allocates at the size the library asks
for. The source note in ``csrc/patch_metrics.cu`` has the steps.
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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        q = lib.patch_metrics_scratch_bytes
        q.argtypes = [ctypes.c_int] * 4
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
    events = (batch.x, batch.y, batch.valid)
    slots = (clusters.centroid_x, clusters.centroid_y, clusters.count, clusters.valid)
    x = batch.x
    if x.dim() != 2 or clusters.valid.dim() != 2:
        raise ValueError("patch_metrics takes (W, E) events and (W, K) slots")
    n_win, e = x.shape
    k = clusters.valid.shape[1]
    index = x.get_device()
    for group, dtypes, shape in ((events, _EVENT_DTYPES, (n_win, e)), (slots, _SLOT_DTYPES, (n_win, k))):
        for a, dt in zip(group, dtypes):
            if a.dtype is not dt:
                raise TypeError(f"patch_metrics takes {dt}, got {a.dtype}")
            if a.shape != shape or a.get_device() != index or index < 0 or not a.is_contiguous():
                raise ValueError(
                    f"patch_metrics takes contiguous {shape} tensors on one CUDA device, got "
                    f"{tuple(a.shape)} on {a.device}"
                )
    out = torch.empty((len(M.METRIC_NAMES), n_win, k), dtype=torch.float32, device=x.device)
    launch = _launcher()
    key = (index, e, k, width, height)
    per = _scratch_bytes.get(key)
    if per is None:  # asked once per device and sizes
        per = _scratch_bytes[key] = _build.launch_on(
            index, lambda _stream: _fns["scratch"](e, k, width, height))
    scratch = (torch.empty(n_win * per, dtype=torch.uint8, device=x.device)
               if per and n_win and k else None)
    err = _build.launch_on(index, lambda stream: launch(
        *(a.data_ptr() for a in events + slots), n_win, e, k, width, height,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), stream,
    ))
    _build.check(err, "patch_metrics")
    return dict(zip(M.METRIC_NAMES, out.unbind(0)))
