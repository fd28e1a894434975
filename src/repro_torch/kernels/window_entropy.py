"""Per-cluster window entropy metrics (CUDA C++).

Replaces the TPU kernel ``repro/kernels/window_entropy.py:
window_entropy``: per cluster centre, the 48x48 slice of a ``[0, 1]``
frame (origin clipped into the frame) -> 32-bin Shannon entropy, Renyi
entropy of order 2 and the population standard deviation. No pipeline
route reaches it, in the reference as here.

Bound on the H100: the distinct frame pixels the slices cover, 20 bytes
a centre, or about 10 operations a pixel of each slice where slices
overlap. Design (``csrc/window_entropy.cu``): no atomics; the launch
takes the ``"wide"`` path (a 768-thread CTA a centre, the histogram by
warp votes) while the card holds every centre's CTA at once, else the
``"warp"`` path (a warp a centre, a private shared-memory histogram
column a lane); on an H100 each is the faster on its side of that switch
(K = 264 of 132 SMs). Its float32 sums run in another order than the plain
version's: rtol 1e-5.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

WINDOW = 48  # compiled into the kernel
BINS = 32
PATHS = {"auto": 0, "wide": 1, "warp": 2}

_loaded = None


def _lib():
    global _loaded
    if _loaded is None:
        lib = _build.load("window_entropy")
        lib.window_entropy_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.window_entropy_launch.restype = ctypes.c_int
        lib.window_entropy_plan.argtypes = [ctypes.c_int]
        lib.window_entropy_plan.restype = ctypes.c_int
        _loaded = lib
    return _loaded


def plan(k: int, device: torch.device) -> str:
    """The path a launch of ``k`` centres takes on CUDA ``device``."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    code = _build.launch_on(index, lambda _: _lib().window_entropy_plan(k))
    return next(name for name, c in PATHS.items() if c == code)


def window_entropy(frame: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Launch on a contiguous ``(H, W)`` CUDA float32 frame (H, W >= 48)
    and ``(K,)`` int32 centres; returns ``(3, K)`` float32 rows Shannon,
    Renyi, contrast. The path is :func:`plan`'s."""
    return _launch(frame, cx, cy, "auto")


def _launch(frame: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, path: str) -> torch.Tensor:
    """:func:`window_entropy` on ``path``: ``"auto"`` (:func:`plan`'s
    choice), or ``"wide"`` or ``"warp"`` forced, to test and time each."""
    if frame.dim() != 2 or min(frame.shape) < WINDOW:
        raise ValueError(f"window_entropy takes an (H, W) frame with H, W >= {WINDOW}, "
                         f"got {tuple(frame.shape)}")
    if cx.dim() != 1 or cy.shape != cx.shape:
        raise ValueError(f"window_entropy takes (K,) centres, got {tuple(cx.shape)}, {tuple(cy.shape)}")
    for a, dt in ((frame, torch.float32), (cx, torch.int32), (cy, torch.int32)):
        if a.device.type != "cuda" or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"window_entropy takes contiguous CUDA {dt}, got {a.dtype} on {a.device}")
    if path not in PATHS:
        raise ValueError(f"window_entropy path is one of {sorted(PATHS)}, got {path!r}")
    k = cx.shape[0]
    out = torch.empty((3, k), dtype=torch.float32, device=frame.device)
    err = _build.launch_on(frame.device.index, lambda stream: _lib().window_entropy_launch(
        frame.data_ptr(), frame.shape[0], frame.shape[1], cx.data_ptr(), cy.data_ptr(),
        k, PATHS[path], out.data_ptr(), stream,
    ))
    _build.check(err, "window_entropy")
    return out
