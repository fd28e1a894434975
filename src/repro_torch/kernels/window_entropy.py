"""Per-cluster window entropy metrics (CUDA C++).

Replaces the TPU kernel ``repro/kernels/window_entropy.py:
window_entropy``: per cluster centre, the 48x48 slice of a ``[0, 1]``
frame (origin clipped into the frame) -> 32-bin Shannon entropy, Renyi
entropy of order 2 and the population standard deviation. No pipeline
route reaches it, in the reference as here.

Bound on the H100: bytes, 9,216 per cluster slice and 12 out. Design:
one CTA per cluster, the histogram in shared memory with integer
atomics, block reductions for the mean and the squared deviations. Its
float32 sums run in another order than the plain version's: rtol 1e-5.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

WINDOW = 48  # compiled into the kernel
BINS = 32

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("window_entropy").window_entropy_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def window_entropy(frame: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Launch on a contiguous ``(H, W)`` CUDA float32 frame (H, W >= 48)
    and ``(K,)`` int32 centres; returns ``(3, K)`` float32 rows Shannon,
    Renyi, contrast."""
    if frame.dim() != 2 or min(frame.shape) < WINDOW:
        raise ValueError(f"window_entropy takes an (H, W) frame with H, W >= {WINDOW}, "
                         f"got {tuple(frame.shape)}")
    if cx.dim() != 1 or cy.shape != cx.shape:
        raise ValueError(f"window_entropy takes (K,) centres, got {tuple(cx.shape)}, {tuple(cy.shape)}")
    for a, dt in ((frame, torch.float32), (cx, torch.int32), (cy, torch.int32)):
        if a.device.type != "cuda" or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"window_entropy takes contiguous CUDA {dt}, got {a.dtype} on {a.device}")
    k = cx.shape[0]
    out = torch.empty((3, k), dtype=torch.float32, device=frame.device)
    err = _build.launch_on(frame.device.index, lambda stream: _launcher()(
        frame.data_ptr(), frame.shape[0], frame.shape[1], cx.data_ptr(), cy.data_ptr(),
        k, out.data_ptr(), stream,
    ))
    _build.check(err, "window_entropy")
    return out
