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

The int8 collectives, over a ``torch.distributed`` process group, one
process a rank (the reference's run inside ``shard_map`` over a mesh
axis; ``axis_name`` is the group here, and ``axis_size`` its size):

* :func:`compressed_psum_int8` — all-reduce-mean with an int8 payload:
  one scalar max aligns the ranks' scales, then the aligned int8 payloads
  are summed widened to int32.
* :func:`dp_grad_sync_int8` — that over every leaf of a gradient tree.
* :func:`ring_allreduce_int8` — the two-phase ring (N-1 hops of
  reduce-scatter, N-1 of all-gather), every hop carrying an int16 payload
  of |x|/N elements of partial sums.

They are written with the functional collectives (the ``_c10d_functional``
operators, which :mod:`repro_torch.launch.op_analysis` counts by kind),
in the reference's order of float operations. NCCL serves CUDA tensors
and gloo CPU tensors; a tensor on the other kind of device raises, and
nothing is copied across. Neither backend has a 16-bit integer type, so
a ring hop ships its int16 payload's bytes (an int16 tensor viewed as
uint8, 2|x|/N bytes) and views them back.
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


# ---------------------------------------------------------------------------
# Int8 collectives over a process group.
# ---------------------------------------------------------------------------

def _group(group):
    """The process group of ``group``: a ``ProcessGroup``, a 1-D
    ``torch.distributed`` ``DeviceMesh``, or ``None`` for the default
    group."""
    import torch.distributed as dist

    if group is None:
        return dist.group.WORLD
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def _check_backend(x: torch.Tensor, pg) -> None:
    import torch.distributed as dist

    backend = str(dist.get_backend(pg)).lower()
    served = {dev for name, dev in (("nccl", "cuda"), ("gloo", "cpu")) if name in backend}
    if served and x.device.type not in served:
        raise ValueError(
            f"a {backend} group reduces {' and '.join(sorted(served))} tensors, got one on "
            f"{x.device}; nothing is copied across"
        )


def _wait(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(t)


def _all_reduce(t: torch.Tensor, op: str, pg) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return _wait(funcol.all_reduce(t, op, pg))


def _aligned_int8(x: torch.Tensor, pg) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank's int8 payload aligned to the group's largest scale, and
    that scale: the first half of :func:`compressed_psum_int8`."""
    q, scale = quantize_int8(x)
    max_scale = _all_reduce(scale, "max", pg)
    rescale = scale / max_scale
    q_aligned = torch.round(q.to(torch.float32) * rescale).to(torch.int8)
    return q_aligned, max_scale


def compressed_psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce-mean of ``x`` over ``group`` with an int8 payload (an
    int8 tensor and one float32 scale, against float32: about 4x fewer
    bytes). Every rank returns the same tensor."""
    import torch.distributed as dist

    pg = _group(group)
    _check_backend(x, pg)
    q_aligned, max_scale = _aligned_int8(x, pg)
    # Widened to int32 against overflow of the sum.
    q_sum = _all_reduce(q_aligned.to(torch.int32), "sum", pg)
    # The reference's psum of ones is the group's size, which every rank
    # knows. A device tensor, not a Python number: CUDA would multiply by
    # the reciprocal of a host scalar, which is not the division.
    n = torch.full((), float(dist.get_world_size(pg)), dtype=torch.float32, device=x.device)
    return q_sum.to(torch.float32) * max_scale / n


def dp_grad_sync_int8(grads: Any, group=None) -> Any:
    """:func:`compressed_psum_int8` over every leaf of a gradient tree."""
    return _tree_map(lambda g: compressed_psum_int8(g, group), grads)


def _hop(payload: torch.Tensor, rank: int, size: int, pg) -> torch.Tensor:
    """Send ``payload`` (int16) to rank + 1 and return rank - 1's, as its
    bytes: one all-to-all whose only nonzero splits are those two."""
    import torch.distributed._functional_collectives as funcol

    wire = payload.contiguous().view(torch.uint8)
    ins, outs = [0] * size, [0] * size
    ins[(rank + 1) % size] = wire.numel()
    outs[(rank - 1) % size] = wire.numel()
    return _wait(funcol.all_to_all_single(wire, outs, ins, pg)).view(torch.int16)


def ring_allreduce_int8(x: torch.Tensor, group=None, axis_size: int | None = None) -> torch.Tensor:
    """All-reduce-mean of ``x`` over ``group`` as a two-phase ring with
    quantized payloads.

    The tensor is flattened, zero-padded to a multiple of the group size N
    and cut into N chunks; one scalar max aligns the scales and every rank
    quantizes to int8. Reduce-scatter: N-1 hops, each sending the next
    rank one chunk of int16 partial sums. All-gather: N-1 hops passing the
    fully reduced chunks on. Every hop carries |x|/N int16 elements, half
    the bytes of float32. ``axis_size``, if given, must be the group's
    size; a group of one returns ``x``."""
    import torch.distributed as dist

    pg = _group(group)
    size = dist.get_world_size(pg)
    if axis_size is not None and axis_size != size:
        raise ValueError(f"axis_size {axis_size} is not the group's size {size}")
    if size == 1:
        return x
    _check_backend(x, pg)
    rank = dist.get_rank(pg)
    orig_shape = x.shape
    n = x.numel()
    pad = (-n) % size
    flat = torch.nn.functional.pad(x.reshape(-1).to(torch.float32), (0, pad))
    chunks = flat.reshape(size, -1)

    _, scale = quantize_int8(chunks)
    max_scale = _all_reduce(scale, "max", pg)
    q = torch.round(chunks / max_scale).clamp(-127, 127).to(torch.int8)

    # Phase 1: reduce-scatter. Partial sums leave int8's range after the
    # first hop, so they travel as int16.
    acc = q.to(torch.int16)
    for i in range(size - 1):
        recv = _hop(acc[(rank - i) % size], rank, size, pg)
        recv_id = (rank - i - 1) % size
        acc[recv_id] = acc[recv_id] + recv

    # Phase 2: all-gather the owned (fully reduced) chunks.
    owned_id = (rank + 1) % size
    gathered = torch.zeros_like(acc)
    payload = acc[owned_id]
    gathered[owned_id] = payload
    pid = owned_id
    for _ in range(size - 1):
        payload = _hop(payload, rank, size, pg)
        pid = (pid - 1) % size
        gathered[pid] = payload
    out = gathered.to(torch.float32) * max_scale / size
    return out.reshape(-1)[:n].reshape(orig_shape)
