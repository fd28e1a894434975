"""Parameter and activation sharding rules (DP / FSDP / TP / EP), and
slot-pool carry migration for the fleet driver.

The port of ``repro.distributed.sharding``. The rules: a leaf's spec is
derived from its parameter's *name* (right-aligned against the leaf's
shape, so the stacked cycle dims of the reference's layout, or none at
all in the port's per-layer parameters, work alike), with divisibility
checks against the mesh: a dim that does not divide by its axis size
falls back to replication. One rule set stays valid across all ten
architectures (40-head MLA, 12-head VLM, 4-head xLSTM, ...).

A spec is a plain tuple, the entries of the reference's ``PartitionSpec``
in order: one entry a dim (``None``, an axis name, or a tuple of names
for a dim sharded over several axes), or ``()`` for a leaf whose name has no
rule, as the reference's ``P()``. The rules read only a mesh's axis
names and sizes (:class:`repro_torch.launch.mesh.Mesh`), so the dry run
(:mod:`repro_torch.launch.dryrun`) feeds them device-free meshes.

Placement: over a mesh of devices
(:class:`~repro_torch.launch.mesh.DeviceMesh`), :func:`place` lays a
tensor out by a spec in one process, the reference's ``device_put`` with a
``NamedSharding`` (:func:`named`), as a :class:`Placed` leaf that holds
every entry's slice on its device. :func:`hint` and its fleet forms are
the identity without an active mesh (:func:`~repro_torch.launch.mesh.use_mesh`);
the fleet places its carry (:func:`hint_fleet`) and each round's wire
(:func:`hint_wire`) with them.

Axis semantics:
  dp   — batch data parallelism (('pod','data') on the multi-pod mesh)
  fsdp — weight/optimizer sharding over the data axis (ZeRO-3 style)
  tp   — tensor parallelism over the model axis; also hosts EP (experts)

The carry half: a stacked fleet carry (every leaf with the sensor dim
leading) shards over the ``sensor`` axis (:func:`shard_fleet_carry`),
grows by zero-padding that dim, since an all-zero slot is the fresh-stream
initial state, and shrinks by slicing it, each re-placed on its mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh, current_mesh, tensor_device, use_mesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    dp: tuple[str, ...] = ("data",)
    fsdp: str | None = "data"
    tp: str | tuple[str, ...] | None = "model"
    ep: str | None = "model"
    # Pure expert parallelism: shard expert weights ONLY over ep. The
    # default also FSDPs the contracting d_model dim, which makes every
    # expert product a partial-sum all-reduce of the (E, C, ff) dispatch
    # tensor.
    moe_ep_only: bool = False


TRAIN_RULES = ShardingRules()
MULTIPOD_TRAIN_RULES = ShardingRules(dp=("pod", "data"))
SERVE_RULES = ShardingRules(fsdp=None)
MULTIPOD_SERVE_RULES = ShardingRules(dp=("pod", "data"), fsdp=None)
# 2D tensor parallelism for tiny-batch serving (long-context decode with
# global_batch=1 leaves the data axis idle: fold it into TP).
SERVE_2D_RULES = ShardingRules(fsdp=None, tp=("model", "data"))
MULTIPOD_SERVE_2D_RULES = ShardingRules(dp=("pod",), fsdp=None, tp=("model", "data"))


# Right-aligned axis-role specs per parameter name. Roles: 'fsdp', 'tp',
# 'ep', None. Names not listed replicate.
_BASE: dict[str, tuple] = {
    # embeddings / heads
    "embed": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # MLA
    "w_dq": ("fsdp", "tp"),
    "w_uq": ("fsdp", "tp"),
    "w_dkv": ("fsdp", "tp"),
    "w_uk": ("fsdp", "tp"),
    "w_uv": ("fsdp", "tp"),
    "w_kr": ("fsdp", None),
    # FFN
    "wi_gate": ("fsdp", "tp"),
    "wi_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # router
    "router": ("fsdp", None),
    # RG-LRU
    "w_gate_branch": ("fsdp", "tp"),
    "w_main": ("fsdp", "tp"),
    "w_input_gate": ("fsdp", "tp"),
    "w_rec_gate": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "log_lambda": ("tp",),
    # xLSTM
    "w_up": ("fsdp", "tp"),
    "w_up_gate": ("fsdp", "tp"),
    "w_igate": ("fsdp", None),
    "w_fgate": ("fsdp", None),
    "w_gates": ("fsdp", "tp"),
    "r_gates": (None, None, "tp"),
    "skip_scale": ("tp",),
}

# Names whose leaves live under a 'moe' subtree get an extra leading expert
# dim sharded over ep.
_MOE_BASE: dict[str, tuple] = {
    "wi_gate": ("ep", "fsdp", None),
    "wi_up": ("ep", "fsdp", None),
    "wo": ("ep", None, "fsdp"),
}

_MOE_BASE_EP_ONLY: dict[str, tuple] = {
    "wi_gate": ("ep", None, None),
    "wi_up": ("ep", None, None),
    "wo": ("ep", None, None),
}


def _role_to_axis(role, rules: ShardingRules):
    if role is None:
        return None
    return getattr(rules, role)


def check_unique(spec: tuple) -> tuple:
    """``spec``, if it maps every mesh axis to one dim at most; else
    ``ValueError``, where the reference's ``NamedSharding`` raises
    ``DuplicateSpecError``."""
    seen: set[str] = set()
    for entry in spec:
        for a in entry if isinstance(entry, tuple) else (entry,) if entry else ():
            if a in seen:
                raise ValueError(f"spec {spec} maps mesh axis {a!r} to two dims")
            seen.add(a)
    return spec


def _resolve(roles: tuple, shape: tuple[int, ...], rules: ShardingRules,
             axis_sizes: dict[str, int]) -> tuple:
    """Right-align roles against shape; drop non-dividing axes. Axis
    entries may be tuples (multi-axis sharding, e.g. 2D TP for serving)."""
    ndim = len(shape)
    spec: list = [None] * ndim
    for i, role in enumerate(roles):
        dim = ndim - len(roles) + i
        if dim < 0:
            continue
        axis = _role_to_axis(role, rules)
        if axis is None:
            continue
        parts = axis if isinstance(axis, tuple) else (axis,)
        present = tuple(a for a in parts if a in axis_sizes)
        if not present:
            continue
        size = 1
        for a in present:
            size *= axis_sizes[a]
        if shape[dim] % size != 0:
            continue
        spec[dim] = present if len(present) > 1 else present[0]
    return check_unique(tuple(spec))


def partition_params(params: Any, rules: ShardingRules, mesh=None) -> Any:
    """Spec tree for a parameter tree whose leaves have a ``shape``.

    ``params`` is nested dicts (the reference's layout, e.g.
    ``models.transformer.named_to_tree``, cycle leaves stacked) or a flat
    dict keyed by dotted names (the port's ``named_parameters``, where a
    name's parts are the path). The result has the same keys. Without a
    mesh every spec replicates.
    """
    axis_sizes = mesh.axis_sizes if mesh is not None else {}
    moe_table = _MOE_BASE_EP_ONLY if rules.moe_ep_only else _MOE_BASE

    def leaf_spec(names: list[str], leaf) -> tuple:
        name = names[-1] if names else ""
        in_moe = "moe" in names[:-1]
        table = moe_table if (in_moe and name in moe_table) else _BASE
        roles = table.get(name)
        if roles is None:
            return ()
        return _resolve(roles, tuple(leaf.shape), rules, axis_sizes)

    def walk(tree, names: list[str]):
        if isinstance(tree, dict):
            return {k: walk(v, names + k.split(".")) for k, v in tree.items()}
        return leaf_spec(names, tree)

    return walk(params, [])


def batch_spec(rules: ShardingRules, extra_dims: int = 1) -> tuple:
    """Spec for (B, ...) inputs: batch over dp axes, rest replicated."""
    dp = rules.dp if len(rules.dp) > 1 else rules.dp[0]
    return (dp,) + (None,) * extra_dims


# ---------------------------------------------------------------------------
# Placement over a mesh of devices, in one process.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh of devices and a spec: one entry a dim (``None``, an axis
    name, or a tuple of names), trailing dims replicated."""
    mesh: DeviceMesh
    spec: tuple

    @property
    def device_set(self) -> set[torch.device]:
        """The distinct devices of the mesh's entries."""
        return set(self.mesh.devices.flat)


def named(mesh: DeviceMesh, spec: tuple) -> NamedSharding:
    """The placement of a leaf by ``spec`` over ``mesh``, the reference's
    ``NamedSharding(mesh, spec)``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"named takes a mesh of devices (launch.mesh.make_mesh), got {mesh!r}")
    return NamedSharding(mesh, tuple(spec))


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _dim_slices(shape: tuple[int, ...], sharding: NamedSharding, coord: tuple[int, ...]) -> tuple:
    """The slice of every dim that mesh entry ``coord`` holds."""
    mesh = sharding.mesh
    out = []
    for d, size in enumerate(shape):
        axes = _axes(sharding.spec[d]) if d < len(sharding.spec) else ()
        parts, block = 1, 0
        for a in axes:  # row-major over the named axes, as a PartitionSpec
            k = mesh.axis_names.index(a)
            block = block * mesh.shape[k] + coord[k]
            parts *= mesh.shape[k]
        step = size // parts
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


def _check_divides(shape: tuple[int, ...], sharding: NamedSharding) -> None:
    mesh = sharding.mesh
    if len(sharding.spec) > len(shape):
        raise ValueError(f"spec {sharding.spec} has more entries than a {len(shape)}-dim leaf")
    for d, entry in enumerate(sharding.spec):
        axes = _axes(entry)
        unknown = [a for a in axes if a not in mesh.axis_names]
        if unknown:
            raise ValueError(f"spec {sharding.spec} names axes {unknown} the mesh lacks")
        parts = math.prod(mesh.axis_sizes[a] for a in axes)
        if shape[d] % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes} ({parts})")


class Placed:
    """A tensor laid out over a :class:`~repro_torch.launch.mesh.DeviceMesh`
    in one process: every mesh entry holds its slice by ``spec`` on its
    device (:meth:`shard`); entries that hold the same slice on the same
    device share one tensor. ``sharding.spec`` is the reference's
    ``leaf.sharding.spec``: ``("sensor",)`` for a sensor-sharded fleet
    leaf, ``()`` for a replicated one. :meth:`full` assembles the global
    tensor; ``np.asarray`` and :meth:`cpu` give it on the host."""

    __slots__ = ("sharding", "shape", "dtype", "_shards")

    def __init__(self, sharding: NamedSharding, shape, dtype: torch.dtype, shards: dict):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self._shards = shards

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def mesh(self) -> DeviceMesh:
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def shard(self, coord: tuple[int, ...]) -> torch.Tensor:
        """The slice mesh entry ``coord`` holds, on its device."""
        return self._shards[tuple(coord)]

    def full(self, device: torch.device | None = None) -> torch.Tensor:
        """The global tensor, assembled on ``device`` (default: the mesh's
        first device)."""
        dev = tensor_device(self.mesh.first_device if device is None else torch.device(device))
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for coord in self.mesh.coords():
            sl = _dim_slices(tuple(self.shape), self.sharding, coord)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in done:
                done.add(key)
                out[sl] = self._shards[coord].to(dev)
        return out

    def cpu(self) -> torch.Tensor:
        return self.full(torch.device("cpu"))

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, i: int) -> torch.Tensor:
        """Row ``i`` of dim 0, from the entry that holds it."""
        if not isinstance(i, int):
            raise TypeError("a Placed leaf is indexed by one int along dim 0; use full() otherwise")
        i = i + self.shape[0] if i < 0 else i
        if all(e is None for e in self.spec[1:]):
            for coord in self.mesh.coords():
                sl = _dim_slices(tuple(self.shape), self.sharding, coord)[0]
                if sl.start <= i < sl.stop:
                    return self._shards[coord][i - sl.start]
        return self.full()[i]

    def __repr__(self) -> str:
        return (f"Placed(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={dict(zip(self.mesh.axis_names, self.mesh.shape))})")


def place(x, sharding: NamedSharding, non_blocking: bool = False) -> Placed:
    """``x`` (a tensor, a numpy array or a :class:`Placed` leaf) laid out
    by ``sharding``, the reference's ``jax.device_put(x, sharding)``:
    every mesh entry gets its slice, copied to its device (entries with the
    same slice on the same device share the copy). Raises when a sharded
    dim does not divide by its axes. ``non_blocking`` copies from pinned
    host memory asynchronously; the caller then keeps ``x`` unchanged
    until the device has read it."""
    if isinstance(x, Placed):
        if x.sharding.mesh is sharding.mesh and x.spec == sharding.spec:
            return x
        x = x.full()
    x = torch.as_tensor(x)
    shape = tuple(x.shape)
    _check_divides(shape, sharding)
    shards, made = {}, {}
    for coord in sharding.mesh.coords():
        dev = tensor_device(sharding.mesh.device_at(coord))
        sl = _dim_slices(shape, sharding, coord)
        key = (tuple((s.start, s.stop) for s in sl), str(dev))
        if key not in made:
            made[key] = x[sl].to(dev, copy=True, non_blocking=non_blocking).contiguous()
        shards[coord] = made[key]
    return Placed(sharding, shape, x.dtype, shards)


def from_blocks(blocks: list[torch.Tensor], mesh: DeviceMesh, spec: tuple) -> Placed:
    """A :class:`Placed` leaf from per-block tensors already computed: the
    spec splits one dim over one axis and ``blocks[b]`` is block ``b``
    along it (one block when the spec splits nothing); entries along the
    other axes hold the same block, moved to their device if it is
    another one."""
    sharding = NamedSharding(mesh, tuple(spec))
    split = [(d, _axes(e)) for d, e in enumerate(spec) if e is not None]
    if len(split) > 1 or (split and len(split[0][1]) != 1):
        raise ValueError(f"from_blocks takes a spec over one axis of one dim, got {spec}")
    k = mesh.axis_names.index(split[0][1][0]) if split else None
    want = mesh.shape[k] if split else 1
    if len(blocks) != want:
        raise ValueError(f"spec {spec} over {mesh.axis_sizes} takes {want} blocks, got {len(blocks)}")
    shape = list(blocks[0].shape)
    if split:
        shape[split[0][0]] *= want
    shards = {}
    for coord in mesh.coords():
        b = blocks[coord[k] if split else 0]
        shards[coord] = b.to(tensor_device(mesh.device_at(coord)))
    return Placed(sharding, shape, blocks[0].dtype, shards)


# ---------------------------------------------------------------------------
# Fleet (multi-sensor streaming) carry sharding and migration.
# ---------------------------------------------------------------------------

# The fleet stacks per-sensor carries (the atlas, the tracker state) along
# a leading sensor dim. Sensors are independent (no cross-sensor operation
# anywhere in the step), so the carry shards 1:1 over a dedicated mesh
# axis and each entry serves S / axis_size sensors.
SENSOR_AXIS = "sensor"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Placed, np.ndarray))


def _map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf (tensor, ``Placed``, numpy array) of a
    tree of dicts, lists, tuples and NamedTuples."""
    if _is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    mapped = [_map(fn, leaf) for leaf in tree]
    return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)


def shard_fleet_carry(tree: Any, mesh: DeviceMesh | None) -> Any:
    """Place a stacked fleet carry tree on ``mesh``, sensor-sharded, by
    :func:`hint_fleet`: every leaf has the sensor dim leading, and a leaf
    whose sensor count divides the ``sensor`` axis gets spec
    ``("sensor",)``, every other leaf ``()`` (replicated), as
    :func:`partition_params`' divisibility rule. ``mesh=None``, or a mesh
    without a ``sensor`` axis, gives the identity."""
    if mesh is None or SENSOR_AXIS not in mesh.axis_names:
        return tree
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"shard_fleet_carry takes a mesh of devices (launch.mesh.make_mesh), got {mesh!r}")
    with use_mesh(mesh):
        return hint_fleet(tree)


def assemble(leaf) -> torch.Tensor:
    """The global tensor of a leaf: a ``Placed`` leaf assembled on its
    mesh's first device, a tensor (or numpy array) as it is."""
    return leaf.full() if isinstance(leaf, Placed) else torch.as_tensor(leaf)


def grow_fleet_carry(tree: Any, new_size: int, mesh: DeviceMesh | None = None) -> Any:
    """Zero-pad every leaf's leading sensor dim to ``new_size`` slots (a
    zeroed slot is the fresh-stream state), then re-place the tree with
    :func:`shard_fleet_carry`: a promotion keeps the carry sharded,
    including when the old capacity did not divide the axis and the new
    one does."""

    def pad(leaf) -> torch.Tensor:
        leaf = assemble(leaf)
        extra = new_size - leaf.shape[0]
        if extra < 0:
            raise ValueError(
                f"fleet carry has {leaf.shape[0]} slots, cannot shrink to {new_size}"
            )
        if extra == 0:
            return leaf
        return torch.cat([leaf, leaf.new_zeros((extra,) + tuple(leaf.shape[1:]))])

    return shard_fleet_carry(_map(pad, tree), mesh)


def shrink_fleet_carry(tree: Any, new_size: int, mesh: DeviceMesh | None = None) -> Any:
    """Keep the first ``new_size`` slots of every leaf (the caller
    guarantees the dropped tail slots are free), then re-place the tree
    with :func:`shard_fleet_carry`."""
    if new_size < 1:
        raise ValueError(f"need at least one slot, got {new_size}")

    def cut(leaf) -> torch.Tensor:
        leaf = assemble(leaf)
        if leaf.shape[0] < new_size:
            raise ValueError(f"fleet carry has {leaf.shape[0]} slots, cannot take {new_size}")
        return leaf[:new_size]

    return shard_fleet_carry(_map(cut, tree), mesh)


def sensor_blocks(leaf) -> list[tuple[int, int, tuple | None, torch.Tensor]]:
    """``(lo, hi, coord, tensor)`` of every block of sensors a fleet leaf
    is held in: a plain tensor is one block (``coord`` None); a ``Placed``
    leaf of spec ``("sensor",)`` one block a ``sensor`` entry (from the
    first entry along any other axis), and a replicated one a single
    block, the mesh's first entry's."""
    if not isinstance(leaf, Placed):
        return [(0, leaf.shape[0], None, leaf)]
    mesh = leaf.mesh
    coord0 = (0,) * len(mesh.shape)
    if not leaf.spec or leaf.spec[0] is None:
        return [(0, leaf.shape[0], coord0, leaf.shard(coord0))]
    k = mesh.axis_names.index(SENSOR_AXIS)
    n = mesh.shape[k]
    step = leaf.shape[0] // n
    out = []
    for b in range(n):
        coord = tuple(b if i == k else 0 for i in range(len(mesh.shape)))
        out.append((b * step, (b + 1) * step, coord, leaf.shard(coord)))
    return out


def join_sensor_blocks(blocks: list[torch.Tensor], like):
    """The inverse of :func:`sensor_blocks`: per-block tensors back into a
    leaf laid out as ``like`` (a plain tensor when ``like`` is one)."""
    if not isinstance(like, Placed):
        return blocks[0]
    spec = (SENSOR_AXIS,) if like.spec and like.spec[0] is not None else ()
    return from_blocks(blocks, like.mesh, spec)


# ---------------------------------------------------------------------------
# Sharding hints (the identity without an active mesh of devices).
# ---------------------------------------------------------------------------

def hint(x, *axes, non_blocking: bool = False):
    """``x`` placed by ``axes`` (one entry a dim: an axis name, a tuple of
    names, or ``None``) over the mesh :func:`~repro_torch.launch.mesh.use_mesh`
    made active; an axis the mesh lacks, or whose size does not divide the
    dim, falls back to replication. The identity without an active mesh
    of devices, as the reference's ``with_sharding_constraint`` hint.
    ``non_blocking`` as :func:`place`'s."""
    mesh = current_mesh()
    if not isinstance(mesh, DeviceMesh):
        return x
    sizes = mesh.axis_sizes
    spec = []
    for dim, a in enumerate(axes):
        present = tuple(p for p in _axes(a) if p in sizes)
        total = math.prod(sizes[p] for p in present)
        if present and x.shape[dim] % total == 0:
            spec.append(present if len(present) > 1 else present[0])
        else:
            spec.append(None)
    while spec and spec[-1] is None:
        spec.pop()
    return place(x, named(mesh, tuple(spec)), non_blocking=non_blocking)


def hint_fleet(tree: Any) -> Any:
    """The sensor-axis hint over every leaf of a stacked fleet tree."""
    return _map(lambda a: hint(a, SENSOR_AXIS), tree)


# The sensor dim of each surface of a fleet round's wire; None for the
# ragged wire's 1-D streams, which are in occupancy order, not by sensor.
WIRE_SENSOR_DIMS = dict(meta=1, packed=1, valid=0, offsets=0, words=None, dt=None, pol=None, spill=None)


def hint_wire(**surfaces) -> dict:
    """Sensor-axis hints for the surfaces of a fleet round's wire, by name:
    the ``(2, S)`` tags and window counts ``meta``; the dense wire's
    ``(4, S, W, cap)`` planes ``packed`` and ``(S, W, cap)`` mask
    ``valid``; the ragged wire's ``(S, W+1)`` CSR ``offsets``. These
    shard over the ``sensor`` axis like the carry. The ragged wire's
    streams ``words``, ``dt``, ``pol`` and ``spill`` stay replicated, one
    copy a device: every block decodes its own rows of ``offsets`` from
    the whole wire. The copies are asynchronous (the fleet's staging ring
    keeps the host buffers until the round is done). The identity without
    an active mesh of devices."""
    out = {}
    for name, x in surfaces.items():
        d = WIRE_SENSOR_DIMS[name]
        axes = () if d is None else (None,) * d + (SENSOR_AXIS,)
        out[name] = hint(x, *axes, non_blocking=True)
    return out
