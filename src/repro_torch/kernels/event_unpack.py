"""The ragged-wire decode in one kernel (CUDA C++), two launches.

Replaces the TPU kernel ``repro/kernels/event_unpack.py:event_unpack``
and the decode around it (``repro/core/events.py:unpack_wire``), the
``use_kernels=True`` wire decoder of the stream and fleet drivers: wire
words, 16-bit deltas, the polarity bitplane, CSR offsets and the spill
lane in; the dense ``(4, S, W, cap)`` int32 planes and the ``(S, W,
cap)`` validity mask out.

Bound on the H100: bytes, 17 written per dense slot and 6.125 read per
wire event plus the offsets and the spill lane. Design: a gather launch
with one thread per dense slot writes every plane once, coalesced; an
overlay launch with one thread per spill entry then writes the exact
int32 values of the events the packed lanes cannot hold, after a binary
search for the window that holds each wire position. The source note in
``csrc/event_unpack.cu`` states the wires it is exact on: every wire the
packer writes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("event_unpack").event_unpack_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def event_unpack(
    words: torch.Tensor,
    dt16: torch.Tensor,
    pol: torch.Tensor,
    offsets: torch.Tensor,
    spill: torch.Tensor,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch on contiguous CUDA tensors: words ``(N,)`` int32 (the
    uint32 bits), dt ``(N,)`` int16 (the uint16 bits), pol ``(N/32,)``
    int32, offsets ``(S, W+1)`` int32 and spill ``(5, M)`` int32. Returns
    packed ``(4, S, W, capacity)`` int32 and valid ``(S, W, capacity)``
    bool."""
    n = words.shape[0]
    if words.dim() != 1 or dt16.shape != words.shape or pol.shape != (n // 32,) or n % 32:
        raise ValueError(
            f"event_unpack takes words (N,), dt (N,), pol (N/32,) with N % 32 == 0; got "
            f"{tuple(words.shape)}, {tuple(dt16.shape)}, {tuple(pol.shape)}"
        )
    if offsets.dim() != 2 or spill.dim() != 2 or spill.shape[0] != 5:
        raise ValueError(
            f"event_unpack takes offsets (S, W+1) and spill (5, M); got "
            f"{tuple(offsets.shape)}, {tuple(spill.shape)}"
        )
    for a, dt in ((words, torch.int32), (dt16, torch.int16), (pol, torch.int32),
                  (offsets, torch.int32), (spill, torch.int32)):
        if a.device.type != "cuda" or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"event_unpack takes contiguous CUDA {dt}, got {a.dtype} on {a.device}")
    s, w = offsets.shape[0], offsets.shape[1] - 1
    dev = words.device
    packed = torch.empty((4, s, w, capacity), dtype=torch.int32, device=dev)
    valid = torch.empty((s, w, capacity), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(
            words.data_ptr(), dt16.data_ptr(), pol.data_ptr(), offsets.data_ptr(),
            spill.data_ptr(), n, spill.shape[1], s, w, capacity,
            packed.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "event_unpack")
    return packed, valid
