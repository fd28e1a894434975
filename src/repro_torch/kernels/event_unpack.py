"""The ragged-wire decode in one kernel launch (CUDA C++).

Replaces the TPU kernel ``repro/kernels/event_unpack.py:event_unpack``
and the decode around it (``repro/core/events.py:unpack_wire``), the
``use_kernels=True`` wire decoder of the stream and fleet drivers: wire
words, 16-bit deltas, the polarity bitplane, CSR offsets and the spill
lane in; the dense ``(4, S, W, cap)`` int32 planes and the ``(S, W,
cap)`` validity mask out.

Bound on the H100: bytes, 17 written per dense slot and 6.125 read per
wire event plus the offsets and the spill lane; on a live feed of 1-2
windows the launch itself is the floor. Design: one CTA per (sensor,
window) row writes every slot of its row once, coalesced; where the
spill lane holds entries, the CTA first scans it and each slot takes the
exact int32 values of the last entry at its wire position. The source
note in ``csrc/event_unpack.cu`` has the details. The wrapper is lean:
one output buffer, no device switch when the tensors lie on the current
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_fn = None
_DTYPES = (torch.int32, torch.int16, torch.int32, torch.int32, torch.int32)


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
    """Launch on contiguous CUDA tensors of one device: words ``(N,)``
    int32 (the uint32 bits), dt ``(N,)`` int16 (the uint16 bits), pol
    ``(N/32,)`` int32, offsets ``(S, W+1)`` int32 and spill ``(5, M)``
    int32. Returns packed ``(4, S, W, capacity)`` int32 and valid ``(S,
    W, capacity)`` bool, views of one buffer."""
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
    dev = words.device
    args = (words, dt16, pol, offsets, spill)
    for a, dt in zip(args, _DTYPES):
        if a.dtype != dt or not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError(
                f"event_unpack takes contiguous {dt} on one CUDA device, got {a.dtype} on {a.device}"
            )
    s, w = offsets.shape[0], offsets.shape[1] - 1
    plane = s * w * capacity
    # One allocation: the four int32 planes, then the bool mask. as_strided
    # takes one dispatch where a slice and a reshape take two.
    buf = torch.empty(4 * plane + (plane + 3) // 4, dtype=torch.int32, device=dev)
    packed = buf.as_strided((4, s, w, capacity), (plane, w * capacity, capacity, 1))
    valid = buf.view(torch.bool).as_strided((s, w, capacity), (w * capacity, capacity, 1), 16 * plane)
    err = _build.launch_on(dev.index, lambda stream: _launcher()(
        *(a.data_ptr() for a in args), n, spill.shape[1], s, w, capacity,
        packed.data_ptr(), valid.data_ptr(), stream,
    ))
    _build.check(err, "event_unpack")
    return packed, valid
