"""Fused event -> patch + six cluster metrics kernel (CUDA C++).

Replaces the TPU kernel ``repro/kernels/patch_metrics.py:patch_metrics``,
the ``metrics_impl="kernel"`` route of the metrics stage.

Bound on the H100: by bytes it is tiny. It reads the valid flag of
every slot; for each valid slot 12 bytes (x0, y0, count int32) and, once
per window that holds one, the window's E events of 14 bytes (x, y, c
int32; weight, leader bool) and its normalizer; it writes 24 bytes per
slot. The work per valid slot is the 2304-pixel Sobel and its
reductions (about 25 float32 operations a pixel) plus a pass over the
window's events, so with many valid slots the float32 rate bounds it.
Design: one CTA per (window, slot) keeps the 48x48 int32 patch (9 KB),
the per-pixel squared magnitudes (9 KB) and 32 bins in shared memory,
scatters with shared-memory atomics, reduces with warp shuffles, and
never writes a patch to device memory. Invalid slots exit at once, so
the time follows the valid clusters, not the K slots.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

WINDOW = 48  # compiled into the kernel
BINS = 32
N_METRICS = 6

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("patch_metrics").patch_metrics_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def patch_metrics(
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    c: torch.Tensor,
    leader: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    count: torch.Tensor,
    cvalid: torch.Tensor,
    norm: torch.Tensor,
) -> torch.Tensor:
    """Launch on contiguous CUDA tensors: events ``(W, E)`` (x, y, c int32;
    w, leader bool), slots ``(W, K)`` (x0, y0, count int32; cvalid bool),
    norm ``(W,)`` float32. Returns ``(W, K, 6)`` float32 in
    ``METRIC_NAMES`` order."""
    ev = ((x, torch.int32), (y, torch.int32), (w, torch.bool), (c, torch.int32), (leader, torch.bool))
    sl = ((x0, torch.int32), (y0, torch.int32), (count, torch.int32), (cvalid, torch.bool))
    n_win, e = x.shape
    k = x0.shape[-1]
    for (a, dt), shape in [(p, (n_win, e)) for p in ev] + [(p, (n_win, k)) for p in sl] + [
        ((norm, torch.float32), (n_win,))
    ]:
        if a.device.type != "cuda" or a.dtype != dt or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"patch_metrics takes contiguous CUDA {dt} {shape}, "
                f"got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    out = torch.empty((n_win, k, N_METRICS), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            *(a.data_ptr() for a in (x, y, w, c, leader, x0, y0, count, cvalid, norm)),
            n_win, e, k, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "patch_metrics")
    return out
