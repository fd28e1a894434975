"""Meshes: device-free descriptions, meshes of devices, and the NVIDIA H100
constants of the roofline.

The port of ``repro.launch.mesh``. The reference builds ``jax.make_mesh``
meshes over its devices. Here there are two kinds:

* :class:`Mesh` — axis names and sizes only, with no device behind it. The
  sharding rules (:mod:`repro_torch.distributed.sharding`) and the dry run
  (:mod:`repro_torch.launch.dryrun`) read only these, as the reference's
  own tests read ``_FakeMesh``, so making one touches no card;
  :func:`make_production_mesh` gives the reference's 256- and 512-device
  pods this way.
* :class:`DeviceMesh` — a :class:`Mesh` that also holds one
  ``torch.device`` per entry, arranged by axis (:func:`make_mesh`). It
  places tensors in one process (:func:`repro_torch.distributed.sharding.place`):
  a leaf sharded over an axis is held as one block per entry, on that
  entry's device. A mesh may name one device more than once; its blocks
  are then separate tensors on that device. That is how one H100 stands in
  for several cards, and how ``torch.device("cpu", i)`` entries stand in
  for the reference's ``--xla_force_host_platform_device_count`` host
  devices (tensors made for any of them land on the plain CPU).

:func:`use_mesh` makes a mesh the active one, which the sharding hints
read; :func:`shard_map` runs a function once per block of one mesh axis,
with no collective inside. Collectives across processes are
:mod:`repro_torch.distributed.compression`'s, over a
``torch.distributed`` process group.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh, outermost axis first."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes {self.axis_names}")

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh(Mesh):
    """A :class:`Mesh` with a ``torch.device`` at every entry: ``devices``
    is an object array of the mesh's shape, as ``jax.sharding.Mesh``'s."""
    devices: np.ndarray = None

    def __post_init__(self):
        super().__post_init__()
        if self.devices is None or tuple(self.devices.shape) != tuple(self.shape):
            raise ValueError(f"a {self.shape} mesh needs a device array of that shape")

    def device_at(self, coord: tuple[int, ...]) -> torch.device:
        return self.devices[tuple(coord)]

    def coords(self) -> list[tuple[int, ...]]:
        """Every entry's coordinate, in row-major order."""
        return [tuple(int(i) for i in c) for c in np.ndindex(*self.shape)]

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]


def tensor_device(device: torch.device) -> torch.device:
    """Where a tensor for mesh entry ``device`` lives: the device itself,
    except that every ``torch.device("cpu", i)`` is the plain CPU."""
    return torch.device("cpu") if device.type == "cpu" else device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 two-pod (512 devices),
    device-free."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None) -> DeviceMesh:
    """A mesh of devices, e.g. ``make_mesh((4,), ("sensor",))`` or (4, 2)
    over ("data", "model"). ``devices`` lists one device per entry in
    row-major order (a device may repeat); ``None`` takes every visible
    CUDA device, and raises when there is none or their count is not the
    mesh's size. A device-free description is :class:`Mesh`."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh places its entries on the visible CUDA devices and "
                "torch.cuda.is_available() is False; pass devices= (e.g. "
                "[torch.device('cpu', i) for i in range(n)])"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None
            else d for d in devs]
    odd = [str(d) for d in devs if d.type not in ("cpu", "cuda")]
    if odd:
        raise ValueError(f"a mesh entry is a CPU or CUDA device, got {odd}")
    if len(devs) != math.prod(shape):
        raise ValueError(f"a {shape} mesh has {math.prod(shape)} entries, got {len(devs)} devices")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return DeviceMesh(shape, axes, grid.reshape(shape))


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def current_mesh() -> Mesh | None:
    """The mesh :func:`use_mesh` made active, or ``None``."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the active mesh inside the ``with`` block (the
    sharding hints read it); ``None`` deactivates any mesh."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def _is_spec(spec) -> bool:
    return isinstance(spec, tuple) and all(e is None or isinstance(e, str) for e in spec)


def _spec_axis(spec) -> tuple[int, str] | None:
    """(dim, axis) of the one mesh axis a spec splits, or None."""
    found = [(d, a) for d, a in enumerate(spec) if a is not None]
    if len(found) > 1:
        raise ValueError(f"shard_map splits over one axis of one dim, got spec {spec}")
    return found[0] if found else None


def _map_arg(fn, arg, spec):
    """``fn(leaf, leaf_spec)`` over a tensor argument, or over the leaves
    of a tuple-shaped one (one spec for every leaf, or one spec a leaf)."""
    if not isinstance(arg, tuple):
        return fn(arg, spec)
    specs = [spec] * len(arg) if _is_spec(spec) else list(spec)
    parts = [fn(a, s) for a, s in zip(arg, specs)]
    return type(arg)(*parts) if hasattr(arg, "_fields") else type(arg)(parts)


def shard_map(fn: Callable, mesh: DeviceMesh, in_specs: tuple, out_specs) -> Callable:
    """``fn`` run once per block of one mesh axis, with no collective.

    ``in_specs`` has one entry a positional argument: a spec, or for a
    tuple-shaped argument (a NamedTuple of tensors) one spec for every
    leaf or a tuple of specs. A spec is a tuple naming the split axis at
    the split dim (``("node",)``), or ``()`` for a leaf every block reads
    whole. Block ``b`` of the axis runs ``fn`` on its slices, on the device
    of its entry (the first entry along any other axis); the block results
    become :class:`~repro_torch.distributed.sharding.Placed` leaves of
    spec ``out_specs``, one block an entry. Arguments may be tensors or
    ``Placed`` leaves."""
    from repro_torch.distributed.sharding import Placed, from_blocks

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map got {len(args)} arguments for {len(in_specs)} specs")
        axes = set()

        def note(leaf, spec) -> None:
            hit = _spec_axis(spec)
            if hit is not None:
                axes.add(hit[1])

        for arg, spec in zip(args, in_specs):
            _map_arg(note, arg, spec)
        note(None, out_specs)
        if len(axes) != 1:
            raise ValueError(f"shard_map maps over exactly one mesh axis, got {sorted(axes)}")
        axis = axes.pop()
        k = mesh.axis_names.index(axis)
        n = mesh.shape[k]

        def block(leaf, spec, b: int, dev: torch.device) -> torch.Tensor:
            whole = leaf.full(dev) if isinstance(leaf, Placed) else leaf.to(tensor_device(dev))
            hit = _spec_axis(spec)
            if hit is None:
                return whole
            d = hit[0]
            if whole.shape[d] % n:
                raise ValueError(f"dim {d} of size {whole.shape[d]} does not split into {n} blocks")
            size = whole.shape[d] // n
            return whole.narrow(d, b * size, size)

        outs = []
        for b in range(n):
            dev = mesh.device_at(tuple(b if i == k else 0 for i in range(len(mesh.shape))))
            outs.append(fn(*(
                _map_arg(lambda a, s: block(a, s, b, dev), arg, spec)
                for arg, spec in zip(args, in_specs)
            )))
        return _place_outs(outs, mesh, out_specs, from_blocks)

    return wrapped


def _place_outs(outs: list, mesh: DeviceMesh, spec, from_blocks) -> Any:
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return from_blocks(outs, mesh, spec)
    parts = [_place_outs([o[i] for o in outs], mesh, spec, from_blocks) for i in range(len(first))]
    return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)


# NVIDIA H100 SXM5 constants for the roofline model (NVIDIA's data sheet,
# dense rates without sparsity, at the 700 W power limit). They replace the
# reference's TPU v5e figures.
PEAK_FLOPS_BF16 = 989e12  # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
# NVLink 4 on the SXM part: 900 GB/s a card both ways, 450 GB/s in each
# direction. The counterpart of the reference's per-direction ICI_BW.
LINK_BW = 450e9
