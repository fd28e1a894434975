"""The paper's grid-quantization IP core over packed words (CUDA C++).

Replaces the TPU kernel ``repro/kernels/grid_quantize.py:
grid_quantize_packed``: packed event word ``(y << 16) | x`` -> packed cell
word ``(cy << 16) | cx``, each 16-bit field divided by ``cell_size`` (a
shift when it is a power of two). No pipeline route reaches it, in the
reference as here.

Bound on the H100: bytes, 8 a word. Design: one thread per word in a
grid-stride loop, coalesced loads and stores.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("grid_quantize").grid_quantize_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grid_quantize_packed(words: torch.Tensor, cell_size: int) -> torch.Tensor:
    """Launch on a contiguous ``(N,)`` CUDA int32 tensor holding the
    uint32 bits of the words; returns ``(N,)`` int32 holding the uint32
    bits of the cell words."""
    if words.dim() != 1 or words.device.type != "cuda" or words.dtype != torch.int32 \
            or not words.is_contiguous():
        raise ValueError(
            f"grid_quantize_packed takes a contiguous (N,) CUDA int32 tensor, got "
            f"{tuple(words.shape)} {words.dtype} on {words.device}"
        )
    if not 1 <= cell_size <= 0xFFFF:
        raise ValueError(f"cell_size must lie in [1, 65535], got {cell_size}")
    out = torch.empty_like(words)
    err = _build.launch_on(words.device.index, lambda stream: _launcher()(
        words.data_ptr(), words.shape[0], cell_size, out.data_ptr(), stream,
    ))
    _build.check(err, "grid_quantize_packed")
    return out
