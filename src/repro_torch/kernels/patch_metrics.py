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
per-pixel values in registers. The source note in
``csrc/patch_metrics.cu`` has the steps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import metrics as M
from repro_torch.kernels import _build

WINDOW = 48  # compiled into the kernel
BINS = 32
MAX_EVENTS = 1024  # the block sort's bound, as the megakernel's
MAX_SLOTS = 128

_fn = None
_EVENT_DTYPES = (torch.int32, torch.int32, torch.bool)
_SLOT_DTYPES = (torch.float32, torch.float32, torch.int32, torch.bool)


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("patch_metrics").patch_metrics_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def patch_metrics(batch, clusters, *, width: int, height: int) -> dict[str, torch.Tensor]:
    """Launch on CUDA tensors of one device, as the window core hands them
    over, contiguous: ``batch.x``, ``batch.y`` ``(W, E)`` int32 and
    ``batch.valid`` bool; ``clusters.centroid_x``/``centroid_y`` ``(W, K)``
    float32, ``count`` int32, ``valid`` bool. Returns the metric dict keyed
    by ``METRIC_NAMES``, each ``(W, K)`` float32, views of one buffer.
    Raises ``TypeError`` for another dtype, ``ValueError`` for another
    layout, for E > 1024 and for K > 128."""
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
    if e > MAX_EVENTS:
        raise ValueError(f"E ({e}) exceeds the kernel's bound ({MAX_EVENTS})")
    if k > MAX_SLOTS:
        raise ValueError(f"K ({k}) exceeds the kernel's bound ({MAX_SLOTS})")
    out = torch.empty((len(M.METRIC_NAMES), n_win, k), dtype=torch.float32, device=x.device)
    err = _build.launch_on(index, lambda stream: _launcher()(
        *(a.data_ptr() for a in events + slots), n_win, e, k, width, height,
        out.data_ptr(), stream,
    ))
    _build.check(err, "patch_metrics")
    return dict(zip(M.METRIC_NAMES, out.unbind(0)))
