"""Int8 quantization with error feedback: the port of the part of
``repro.distributed.compression`` that the constellation's cross-shard
exchange uses.

* :func:`quantize_int8` / :func:`dequantize_int8` — symmetric per-tensor
  int8 (``q``, one float ``scale``), elementwise torch ops on the
  tensor's own device.
* :func:`ef_int8_roundtrip` — quantize-dequantize every leaf of a
  gradient tree, carrying the residual in an error-feedback buffer.

The scale is ``max(amax, 1e-12) / 127``. The reference computes that
division eagerly in ``quantize_int8`` (IEEE division), but inside a
jitted caller XLA rewrites it as ``amax * f32(1/127)``, which differs in
the last bit for some ``amax``. ``jit_scale=True`` gives that second
form; the exchange (:mod:`repro_torch.serve.constellation`) uses it,
because the reference's exchange runs the quantizer under ``jax.jit``.

The int8 collectives of the reference (``compressed_psum_int8``,
``dp_grad_sync_int8``, ``ring_allreduce_int8``) run over a device mesh
and drive data-parallel training; they wait for the mesh (ROADMAP §1
item 7).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

# f32(1/127): the constant XLA multiplies by where a jitted caller wrote
# ``/ 127.0``.
_INV127_F32 = float(np.float32(1.0 / 127.0))


def _float_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the reference's arithmetic runs in: the tensor's own
    floating dtype, float32 for integer or boolean tensors."""
    return x.dtype if x.is_floating_point() else torch.float32


def quantize_int8(x: torch.Tensor, jit_scale: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale), both on ``x``'s device.

    An empty tensor (a zero-size gradient leaf) quantizes to an empty int8
    payload with unit scale: the max over zero elements is undefined, so
    it is never taken. ``jit_scale`` computes the scale as the reference
    does under ``jax.jit`` (see the module docstring)."""
    if x.numel() == 0:
        return x.to(torch.int8), torch.ones((), dtype=torch.float32, device=x.device)
    xf = x.to(_float_dtype(x))
    amax = torch.clamp_min(xf.abs().amax(), 1e-12)
    if jit_scale:
        # A Python scalar: no host-to-device copy, so no synchronization.
        scale = amax * _INV127_F32
    else:
        scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def ef_int8_roundtrip(grads: Any, opt_state: dict) -> tuple[Any, dict]:
    """Quantize-dequantize each gradient leaf with error feedback.

    The EF buffer is carried inside ``opt_state`` under ``'ef'`` (a tree of
    the same structure, float32). Returns the corrected
    (compressed-fidelity) gradients and the updated state."""
    ef = opt_state.get("ef")
    if ef is None:
        ef = _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)

    def leaf(g, e):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        return deq, corrected - deq

    out = _tree_map(leaf, grads, ef)
    new_grads = _tree_map(lambda g, t: t[0], grads, out)
    new_ef = _tree_map(lambda g, t: t[1], grads, out)
    return new_grads, dict(opt_state, ef=new_ef)
