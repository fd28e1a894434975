"""Fleet driver: N live sensors through one step core per round.

The port of ``repro.core.pipeline.fleet``. :class:`FleetPipeline` lifts
the per-sensor streaming carry into a batched :class:`FleetState`: one
host batcher cursor per sensor, and the atlases and tracker states
stacked along a leading sensor dim on the device. Every feed drives all
sensors through one call of the step core over ``(S, W, E)`` windows:
the window stages run over the ``S * W`` windows at once and the tracker
loop over the window axis updates every sensor together.

* **Identity.** Per-sensor outputs equal independent
  :class:`~repro_torch.core.pipeline.stream.StreamingPipeline` runs on
  the same device, to the bit, for any interleaving of feeds. The window
  stages are window-isolated and the tracker update elementwise per
  sensor, so batching cannot mix sensors. Ragged window counts per feed
  are right-padded with all-invalid windows, and each sensor's tracker
  carry is re-selected at its last real window (``n_valid - 1``), so the
  padding coast never reaches the next feed.
* **Tags.** Tags advance per sensor by its real windows; epoch rollover
  (atlas slice zeroed, tag reset) is decided per sensor on the host. The
  round's first tag per sensor ships with ``n_valid`` in the staging
  set's meta rows, and on the event route the atlas event core writes
  each sensor's atlas slice with it.
* **Slot pool.** ``n_sensors`` is the pool's capacity; an idle slot is
  fed ``None``. :meth:`FleetPipeline.reset_slots` zeroes a slot for reuse
  (an all-zero slot carry is the fresh-stream state),
  :meth:`~FleetPipeline.grow` and :meth:`~FleetPipeline.shrink` migrate
  the carry into a larger or smaller pool, and
  :meth:`~FleetPipeline.export_slot` / :meth:`~FleetPipeline.import_slot`
  move one slot's carry between pools, or between this package and the
  reference (:func:`slot_carry_from_numpy`).
* **Wire.** ``wire="ragged"`` (the default) packs the round into the
  compressed ingest wire on the host and decodes it on the device: the
  ``event_unpack`` kernel under ``use_kernels``, else the plain decoder.
  ``wire="dense"`` ships the ``(4, S, W, cap)`` planes.
* **Pipelining.** On the card the staging buffers are pinned host memory
  and each round ships with ``non_blocking`` copies on the current
  stream; a CUDA event recorded after the round's last launch says when
  it is done (:class:`PendingRound`). A staging set is refilled only
  after its previous borrower's event has completed. On the CPU every
  round completes before ``feed`` returns.
* **Mesh.** ``mesh=`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`
  with a ``sensor`` axis) places the carry by
  :func:`~repro_torch.distributed.sharding.shard_fleet_carry`: a pool
  whose capacity divides the axis is held as one block of S/n slots a
  ``sensor`` entry, on that entry's device, and otherwise replicated. The
  round's host packing is shared; ``hint_wire`` places the wire as the
  carry (the 1-D streams replicated, the CSR offsets split by sensor),
  and every block decodes its own rows from the whole wire and runs the
  step on its slots, on its device, so each kernel of the step launches
  once a block. Nothing crosses between
  sensors, so the outputs equal the unsharded fleet's to the bit. The
  round's stacked outputs are ``Placed`` leaves laid out like the carry;
  slot surgery, growth and shrinking keep the placement.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.events import (
    SPILL_QUANTUM,
    SPILL_SENTINEL,
    EventBatch,
    WindowedEvents,
    dense_wire_bytes,
    dual_threshold_bounds,
    dual_threshold_closed_bounds,
    monotone_merge,
    pack_bounds_into,
    pack_polarity,
    ragged_wire_bytes,
    spill_pad,
    unpack_wire,
    wire_pad,
)
from repro_torch.core.pipeline.config import PipelineConfig, atlas_shape
from repro_torch.core.pipeline.scan import ScanResult, make_core
from repro_torch.core.pipeline.stream import empty_scan_result, tag_limit
from repro_torch.core.tracking import TrackState, init_tracks, tracks_from_numpy
from repro_torch.distributed.sharding import (
    SENSOR_AXIS,
    Placed,
    grow_fleet_carry,
    hint_wire,
    join_sensor_blocks,
    sensor_blocks,
    shard_fleet_carry,
    shrink_fleet_carry,
)
from repro_torch.launch.mesh import DeviceMesh, tensor_device, use_mesh

_EMPTY = np.zeros(0, np.int64)
_EMPTY_CHUNK = (_EMPTY, _EMPTY, _EMPTY, _EMPTY)

# Slot-pool capacity tiers: a pool is promoted to the next tier, never
# grown by one. Past the last tier, capacity doubles.
DEFAULT_TIERS = (4, 8, 16, 32, 64)

# Staging sets kept alive per packed-block shape; beyond this the least
# recently used ring is dropped.
_MAX_STAGING_SHAPES = 8


def tier_capacity(n: int, tiers: tuple[int, ...] = DEFAULT_TIERS) -> int:
    """Smallest tier capacity holding ``n`` slots (doubling past the end)."""
    if n < 1:
        raise ValueError(f"need at least one slot, got {n}")
    for cap in tiers:
        if n <= cap:
            return cap
    cap = tiers[-1]
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class SensorCursor:
    """Host-side per-sensor batcher cursor."""

    pending: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    events_consumed: int = 0  # stream index of pending[0]
    next_tag: int = 0  # next atlas tag (epoch-local)
    last_t: int | None = None  # newest absorbed timestamp

    @property
    def pending_count(self) -> int:
        return len(self.pending[2])


@dataclasses.dataclass
class FleetState:
    """Batched streaming carry: one cursor per sensor on the host, the
    stacked (leading sensor dim) atlas and tracker carries on the device."""

    cursors: list[SensorCursor]
    atlas: torch.Tensor | Placed  # (S, H+1, max(W, cap)) int32
    tracks: TrackState  # leaves (S, T), laid out as the atlas

    @property
    def n_sensors(self) -> int:
        return len(self.cursors)


def make_fleet_step(config: PipelineConfig, with_tracking: bool = True):
    """The fleet step: the step core over ``(S, W, E)`` windows.

        (packed (4,S,W,cap), valid (S,W,cap), state (S,T), atlas,
         meta (2,S) int32 on the device: tag0 / n_valid) ->
            (final (S,T), clusters (S,W,K), mets (S,W,K), states (S,W,T),
             atlas)

    Sensor ``s``'s windows carry the atlas tags ``tag0[s] + w`` (the
    event core writes them; the other cores leave the atlas as it is).
    ``final`` is each sensor's state after its last real window
    (``n_valid - 1``), or its previous carry when it closed none."""
    core = make_core(config, with_tracking)

    def step(packed, valid, state, atlas, meta):
        tag0, n_valid = meta[0], meta[1]
        batch = EventBatch(packed[0], packed[1], packed[2], packed[3], valid)
        _, clusters, mets, states, atlas = core(batch, state, atlas, tag0)
        if states is None:
            return state, clusters, mets, None, atlas
        s_ix = torch.arange(n_valid.shape[0], device=n_valid.device)
        last = torch.clamp(n_valid.to(torch.int64) - 1, min=0)
        has = (n_valid > 0)[:, None]
        final = TrackState(*(
            torch.where(has, per_w[s_ix, last], prev) for per_w, prev in zip(states, state)
        ))
        return final, clusters, mets, states, atlas

    return step


def make_wire_fn(use_kernels: bool) -> Callable:
    """The ragged-wire decoder, ``(words, dt, pol, offsets, spill,
    capacity) -> (packed (4,S,W,cap) int32, valid (S,W,cap) bool)``:
    ``ops.event_unpack`` (the CUDA kernel on the card) under
    ``use_kernels``, else the plain decoder :func:`unpack_wire`."""
    if use_kernels:
        from repro_torch.kernels import ops as kops

        return kops.event_unpack
    return unpack_wire


@dataclasses.dataclass
class WireStats:
    """Host->device ingest bytes, accumulated per round. ``wire_bytes`` is
    what the active wire mode ships, ``dense_bytes`` the dense-equivalent
    cost of the same rounds, so ``compression`` is the transfer reduction
    the ragged wire delivers at the workload's occupancy."""

    rounds: int = 0
    events: int = 0  # real (valid) events shipped
    wire_bytes: int = 0
    dense_bytes: int = 0
    spilled: int = 0  # events that took the exact int32 spill lane

    @property
    def compression(self) -> float:
        """Dense-equivalent bytes over shipped bytes (>= 1 when winning)."""
        return self.dense_bytes / self.wire_bytes if self.wire_bytes else 0.0

    @property
    def wire_bytes_per_round(self) -> float:
        return self.wire_bytes / self.rounds if self.rounds else 0.0

    def add(self, other: "WireStats") -> None:
        self.rounds += other.rounds
        self.events += other.events
        self.wire_bytes += other.wire_bytes
        self.dense_bytes += other.dense_bytes
        self.spilled += other.spilled


@dataclasses.dataclass
class SlotCarry:
    """One slot's complete streaming carry, detached from its pool: the
    host cursor plus host copies of the slot's atlas and tracker slices.
    Importing it into a free slot of another pool of the same config
    resumes the stream to the bit."""

    cursor: SensorCursor
    atlas: np.ndarray  # (H+1, Wd) int32
    tracks: TrackState  # leaves (T,) numpy

    @property
    def pending_count(self) -> int:
        return self.cursor.pending_count


def slot_carry_to_numpy(carry: SlotCarry) -> dict:
    """The carry as plain numpy: ``pending`` (four int64 arrays),
    ``events_consumed``, ``next_tag``, ``last_t``, ``atlas`` and
    ``tracks`` (a dict of arrays by field), the fields of the reference's
    ``SlotCarry`` and its cursor."""
    c = carry.cursor
    return dict(
        pending=tuple(np.array(a, np.int64) for a in c.pending),
        events_consumed=int(c.events_consumed),
        next_tag=int(c.next_tag),
        last_t=None if c.last_t is None else int(c.last_t),
        atlas=np.array(carry.atlas, np.int32),
        tracks={f: np.array(getattr(carry.tracks, f)) for f in TrackState._fields},
    )


def slot_carry_from_numpy(d: dict) -> SlotCarry:
    """A :class:`SlotCarry` from the numpy form of
    :func:`slot_carry_to_numpy`, e.g. built field by field from a slot
    the reference's ``FleetPipeline.export_slot`` gave: a stream started
    in the JAX package resumes in this one."""
    return SlotCarry(
        cursor=SensorCursor(
            pending=tuple(np.array(a, np.int64) for a in d["pending"]),
            events_consumed=int(d["events_consumed"]),
            next_tag=int(d["next_tag"]),
            last_t=None if d["last_t"] is None else int(d["last_t"]),
        ),
        atlas=np.array(d["atlas"], np.int32),
        tracks=TrackState(*(a.numpy() for a in tracks_from_numpy(d["tracks"], "cpu"))),
    )


@dataclasses.dataclass
class FleetResult:
    """Stacked outputs of one fleet round; per-sensor views on demand.

    The stacked leaves stay ``(S, W_max, ...)`` on the device;
    :meth:`sensor` materializes one sensor's trimmed
    :class:`~repro_torch.core.pipeline.scan.ScanResult` from host copies
    of the leaves, made once per round at first use, so its tensors lie
    on the CPU. Under a mesh the stacked leaves are ``Placed``, laid out
    as the carry.
    """

    n_windows: np.ndarray  # (S,) real windows closed this round
    windows: list[WindowedEvents]  # per-sensor host bookkeeping
    clusters: object | None  # Clusters, leaves (S, W_max, K); None if nothing closed
    metrics: dict[str, torch.Tensor] | None
    tracks: TrackState | None  # leaves (S, W_max, T)
    final_tracks: TrackState | None  # leaves (S, T), the corrected carry
    _config: PipelineConfig
    _with_tracking: bool
    _carry_tracks: TrackState  # (S, T) carry after this round
    _events: tuple = ()  # a torch.cuda.Event a device, after the round's last launch
    _host: tuple | None = None
    # (S,) int32 n_windows on the round's device (None if nothing closed):
    # device-side consumers read it without a host-to-device copy.
    n_windows_t: torch.Tensor | None = None

    @property
    def n_sensors(self) -> int:
        return len(self.windows)

    @property
    def total_windows(self) -> int:
        return int(self.n_windows.sum())

    def ready(self) -> bool:
        """True once the device work behind this round has completed."""
        return all(e.query() for e in self._events)

    def block_until_ready(self) -> "FleetResult":
        for e in self._events:
            e.synchronize()
        return self

    def _host_view(self) -> tuple:
        if self._host is None:
            cpu = lambda tree: None if tree is None else type(tree)(*(a.cpu() for a in tree))  # noqa: E731
            self._host = (
                cpu(self.clusters),
                {k: v.cpu() for k, v in self.metrics.items()},
                cpu(self.tracks),
                cpu(self.final_tracks),
            )
        return self._host

    def sensor(self, s: int) -> ScanResult:
        """Sensor ``s``'s trimmed result, equal to the corresponding
        ``StreamingPipeline.feed`` return (on the CPU)."""
        n = int(self.n_windows[s])
        w = self.windows[s]
        if self.clusters is None:
            carry_s = TrackState(*(a[s].cpu() for a in self._carry_tracks))
            return empty_scan_result(self._config, self._with_tracking, carry_s, w)
        clusters_h, mets_h, tracks_h, final_h = self._host_view()
        trim = lambda a: a[s, :n]  # noqa: E731
        return ScanResult(
            t_start_us=w.t_start_us,
            clusters=type(clusters_h)(*(trim(a) for a in clusters_h)),
            metrics={k: trim(v) for k, v in mets_h.items()},
            tracks=TrackState(*(trim(a) for a in tracks_h)) if self._with_tracking else None,
            final_tracks=(
                TrackState(*(a[s] for a in final_h)) if self._with_tracking else None
            ),
            windows=w,
        )

    def results(self) -> list[ScanResult]:
        return [self.sensor(s) for s in range(self.n_sensors)]


@dataclasses.dataclass
class PendingRound:
    """Handle to one dispatched, possibly still running, fleet round:
    :meth:`ready` polls its CUDA event, :meth:`wait` synchronizes on it,
    :meth:`result` returns the :class:`FleetResult` without blocking."""

    _result: FleetResult

    def ready(self) -> bool:
        return self._result.ready()

    def wait(self) -> FleetResult:
        return self._result.block_until_ready()

    def result(self) -> FleetResult:
        return self._result

    @property
    def n_windows(self) -> np.ndarray:
        """(S,) windows closed this round: host data, never blocks."""
        return self._result.n_windows

    @property
    def total_windows(self) -> int:
        return self._result.total_windows


def _host_buffer(shape, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """A zeroed host tensor, in pinned memory when the fleet runs on the
    card (so ``non_blocking`` copies from it are asynchronous)."""
    return torch.zeros(shape, dtype=dtype, pin_memory=pinned)


class _StagingSet:
    """One host staging set for a dense round: the (4, S, W, cap) event
    planes, the (S, W, cap) validity mask and the (2, S) tag / n_valid
    meta rows, as tensors with numpy views for the host packer.
    ``inflight`` is the round that last borrowed the set."""

    def __init__(self, s: int, w: int, cap: int, pinned: bool):
        self.packed_t = _host_buffer((4, s, w, cap), torch.int32, pinned)
        self.valid_t = _host_buffer((s, w, cap), torch.bool, pinned)
        self.meta_t = _host_buffer((2, s), torch.int32, pinned)
        self.packed = self.packed_t.numpy()
        self.valid = self.valid_t.numpy()
        self.meta = self.meta_t.numpy()
        self.inflight: PendingRound | None = None


class _RaggedStagingSet:
    """Host staging for the ragged wire: 1-D word, delta and bitplane
    lanes sized for every slot of every window full, the CSR offsets, a
    growable spill lane (flat, so its used prefix is one contiguous
    ``(5, m_pad)`` block) and the meta rows. The lanes are never zeroed:
    every round rewrites each sensor's offsets row, and the decoder zeroes
    every slot past its window's count, so stale bytes past the round's
    events are unobservable; the spill view is re-sentineled every round.
    The tensors hold the uint32 / uint16 bits as int32 / int16."""

    def __init__(self, s: int, w: int, cap: int, pinned: bool):
        n_max = wire_pad(s * w * cap)
        self.pinned = pinned
        self.words_t = _host_buffer((n_max,), torch.int32, pinned)
        self.dt_t = _host_buffer((n_max,), torch.int16, pinned)
        self.pol_t = _host_buffer((n_max // 32,), torch.int32, pinned)
        self.offsets_t = _host_buffer((s, w + 1), torch.int32, pinned)
        self.meta_t = _host_buffer((2, s), torch.int32, pinned)
        self.words = self.words_t.numpy().view(np.uint32)
        self.dt = self.dt_t.numpy().view(np.uint16)
        self.pol = self.pol_t.numpy().view(np.uint32)
        self.offsets = self.offsets_t.numpy()
        self.meta = self.meta_t.numpy()
        self.pbits = np.zeros(n_max, np.uint8)  # host-only packbits scratch
        self._spill(4 * SPILL_QUANTUM)
        self.inflight: PendingRound | None = None

    def _spill(self, m: int) -> None:
        self.spill_t = _host_buffer((5 * m,), torch.int32, self.pinned)
        self.spill_t.fill_(int(SPILL_SENTINEL))
        self.spill_cap = m

    def reserve_spill(self, m_pad: int) -> None:
        """Grow the spill lane to hold ``m_pad`` entries (amortized)."""
        if m_pad > self.spill_cap:
            self._spill(spill_pad(max(m_pad, 2 * self.spill_cap)))

    def spill_view(self, m_pad: int) -> torch.Tensor:
        return self.spill_t[: 5 * m_pad].view(5, m_pad)


class _StagingPool:
    """A ring of ``depth`` staging sets per packed-block shape. Acquiring
    a set whose previous borrower may still be running waits on that
    round's CUDA event first: refilling a pinned buffer while its copy is
    in flight would corrupt the round."""

    def __init__(self, depth: int = 2, pinned: bool = False):
        if depth < 1:
            raise ValueError(f"staging depth must be >= 1, got {depth}")
        self.depth = depth
        self.pinned = pinned
        self._rings: dict[tuple[int, int, int, str], list] = {}

    def acquire(self, s: int, w: int, cap: int, wire: str = "dense"):
        key = (s, w, cap, wire)
        ring = self._rings.pop(key, None)
        if ring is None:
            cls = _RaggedStagingSet if wire == "ragged" else _StagingSet
            ring = [0, [cls(s, w, cap, self.pinned) for _ in range(self.depth)]]
        self._rings[key] = ring  # reinsert: dict order is the LRU order
        while len(self._rings) > _MAX_STAGING_SHAPES:
            self._rings.pop(next(iter(self._rings)))
        ix, sets = ring
        ring[0] = (ix + 1) % self.depth
        st = sets[ix]
        if st.inflight is not None:
            st.inflight.wait()
            st.inflight = None
        if wire == "dense":
            st.packed.fill(0)
            st.valid.fill(0)
        return st


class FleetPipeline:
    """Batched multi-sensor streaming driver (one step for the fleet).

    >>> fp = FleetPipeline(PipelineConfig(), n_sensors=8, device="cuda")
    >>> out = fp.feed([(x0, y0, t0, p0), None, (x2, y2, t2, p2), ...])
    >>> out.sensor(0).clusters  # == the equivalent StreamingPipeline feed
    >>> tail = fp.flush()       # close every sensor's trailing window

    ``feed`` takes one optional ``(x, y, t, p)`` chunk per sensor (``None``
    = idle) and runs one step over every window that provably closed. A
    chunk with out-of-order timestamps, or a feed closing more windows
    than one tag epoch can address, raises ``ValueError`` before any
    sensor's state changes. ``final`` (a bool or a per-slot mask)
    force-closes trailing windows. :meth:`feed_async` returns the round
    as a :class:`PendingRound` without waiting for the device;
    ``staging_depth`` staging sets per shape let that many rounds be in
    flight. ``mesh=`` shards the carry and the step over the mesh's
    ``sensor`` axis (see the module docstring); the pool then runs on the
    mesh's devices, and ``device`` is not used.
    """

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        n_sensors: int = 1,
        with_tracking: bool = True,
        mesh=None,
        state: FleetState | None = None,
        staging_depth: int = 2,
        wire: str = "ragged",
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"FleetPipeline takes a mesh of devices (launch.mesh.make_mesh), got {mesh!r}")
        if n_sensors < 1:
            raise ValueError(f"n_sensors must be >= 1, got {n_sensors}")
        if wire not in ("dense", "ragged"):
            raise ValueError(f"unknown wire mode: {wire!r}")
        self.config = config
        self.n_sensors = n_sensors
        self.with_tracking = with_tracking
        self.wire = wire
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            on_card = self.device.type == "cuda"
        else:
            self.device = tensor_device(mesh.first_device)
            on_card = any(d.type == "cuda" for d in mesh.devices.flat)
        self.wire_stats = WireStats()
        self._step = make_fleet_step(config, with_tracking)
        self._wire = make_wire_fn(config.use_kernels) if wire == "ragged" else None
        self._tag_limit = tag_limit(config)
        self._staging = _StagingPool(staging_depth, pinned=on_card)
        if state is not None and state.n_sensors != n_sensors:
            raise ValueError(
                f"state has {state.n_sensors} sensors, pipeline expects {n_sensors}"
            )
        self.state = self.init_state() if state is None else state

    def init_state(self) -> FleetState:
        s = self.n_sensors
        tracks = init_tracks(self.config.tracker, self.device)
        atlas, tracks = shard_fleet_carry((
            torch.zeros((s,) + atlas_shape(self.config), dtype=torch.int32, device=self.device),
            TrackState(*(a.new_zeros((s,) + tuple(a.shape)) for a in tracks)),
        ), self.mesh)
        return FleetState(
            cursors=[SensorCursor(pending=_EMPTY_CHUNK) for _ in range(s)],
            atlas=atlas,
            tracks=tracks,
        )

    def feed(self, chunks, final=False) -> FleetResult:
        """Ingest one chunk per sensor; process every closed window in one
        step. ``chunks[s]`` is ``(x, y, t, p)`` or ``None``; ``final`` is
        a bool or a per-sensor mask of slots to force-close."""
        return self._ingest(chunks, final=final).result()

    def feed_async(self, chunks, final=False) -> PendingRound:
        """:meth:`feed` as an explicit pipelined round: the work is queued
        on the device and a :class:`PendingRound` returned at once.
        Validation errors still raise here, before any state changes.
        Rounds complete in order (one stream), and carry surgery never
        touches an earlier round's outputs."""
        return self._ingest(chunks, final=final)

    def flush(self) -> FleetResult:
        """Force-close every sensor's trailing partial window."""
        return self._ingest([None] * self.n_sensors, final=True).result()

    def flush_slots(self, slots) -> FleetResult:
        """Force-close the trailing partial window of ``slots`` only."""
        final = np.zeros(self.n_sensors, bool)
        final[list(slots)] = True
        return self._ingest([None] * self.n_sensors, final=final).result()

    @staticmethod
    def _blockwise(leaf, fn):
        """``fn(block, lo, hi)`` over the sensor blocks a carry leaf is held
        in, joined back into the leaf's layout."""
        return join_sensor_blocks([fn(t, lo, hi) for lo, hi, _, t in sensor_blocks(leaf)], leaf)

    def reset_slots(self, slots) -> None:
        """Zero the named slots' carries (cursor, atlas slice, tracker
        slice) so new sensors can reuse them; any unflushed remainder on
        them is dropped. New tensors are built: an earlier round's
        ``final_tracks`` is never changed in place."""
        slots = list(slots)
        if not slots:
            return
        mask = np.zeros(self.n_sensors, bool)
        mask[slots] = True  # IndexError on out-of-range slots, pre-mutation
        st = self.state
        for s in slots:
            st.cursors[s] = SensorCursor(pending=_EMPTY_CHUNK)

        def zero_block(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
            m = torch.as_tensor(mask[lo:hi], device=t.device)
            return torch.where(m.view((-1,) + (1,) * (t.dim() - 1)), torch.zeros_like(t), t)

        zero = lambda a: self._blockwise(a, zero_block)  # noqa: E731
        self.state = FleetState(
            cursors=st.cursors,
            atlas=zero(st.atlas),
            tracks=TrackState(*(zero(a) for a in st.tracks)),
        )

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.n_sensors:
            raise IndexError(f"slot {slot} out of range for a {self.n_sensors}-slot pool")

    def export_slot(self, slot: int) -> SlotCarry:
        """Copy one slot's complete carry out of the pool (host arrays);
        waits for the device work that computes it. The slot itself is
        left untouched."""
        self._check_slot(slot)
        st = self.state
        return SlotCarry(
            cursor=copy.copy(st.cursors[slot]),
            atlas=st.atlas[slot].cpu().numpy().copy(),
            tracks=TrackState(*(a[slot].cpu().numpy().copy() for a in st.tracks)),
        )

    def import_slot(self, slot: int, carry: SlotCarry) -> None:
        """Install an exported carry into ``slot`` (a free slot). Shapes
        are checked against this pool's config before any change."""
        self._check_slot(slot)
        want = atlas_shape(self.config)
        if tuple(carry.atlas.shape) != want:
            raise ValueError(
                f"carry atlas shape {carry.atlas.shape} does not match this "
                f"pool's config ({want}); same PipelineConfig required"
            )
        st = self.state
        ref = [tuple(a.shape[1:]) for a in st.tracks]
        got = [tuple(np.shape(a)) for a in carry.tracks]
        if ref != got:
            raise ValueError(f"carry tracker shapes {got} do not match this pool's ({ref})")

        def put(a, row):
            def put_block(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
                if not lo <= slot < hi:
                    return t
                out = t.clone()
                out[slot - lo] = torch.as_tensor(np.asarray(row), dtype=t.dtype, device=t.device)
                return out

            return self._blockwise(a, put_block)

        st.cursors[slot] = copy.copy(carry.cursor)
        self.state = FleetState(
            cursors=st.cursors,
            atlas=put(st.atlas, carry.atlas),
            tracks=TrackState(*(put(a, r) for a, r in zip(st.tracks, carry.tracks))),
        )

    def grow(self, new_capacity: int) -> None:
        """Promote the pool to ``new_capacity`` slots; existing slots keep
        their carries, new ones arrive zeroed (free)."""
        if new_capacity < self.n_sensors:
            raise ValueError(
                f"cannot shrink pool from {self.n_sensors} to {new_capacity} "
                "slots; detach sensors instead"
            )
        if new_capacity == self.n_sensors:
            return
        st = self.state
        atlas, tracks = grow_fleet_carry((st.atlas, st.tracks), new_capacity, self.mesh)
        cursors = st.cursors + [
            SensorCursor(pending=_EMPTY_CHUNK) for _ in range(new_capacity - len(st.cursors))
        ]
        self.n_sensors = new_capacity
        self.state = FleetState(cursors=cursors, atlas=atlas, tracks=tracks)

    def shrink(self, new_capacity: int, occupied=()) -> None:
        """Demote the pool to ``new_capacity`` slots; every slot in
        ``occupied`` must survive. Remainders on dropped slots are lost."""
        if new_capacity < 1:
            raise ValueError(f"need at least one slot, got {new_capacity}")
        if new_capacity > self.n_sensors:
            raise ValueError(
                f"cannot shrink pool from {self.n_sensors} to {new_capacity} slots; use grow"
            )
        high = [s for s in occupied if s >= new_capacity]
        if high:
            raise ValueError(
                f"occupied slots {sorted(high)} do not fit a "
                f"{new_capacity}-slot pool; migrate or evict them first"
            )
        if new_capacity == self.n_sensors:
            return
        st = self.state
        atlas, tracks = shrink_fleet_carry((st.atlas, st.tracks), new_capacity, self.mesh)
        self.n_sensors = new_capacity
        self.state = FleetState(cursors=st.cursors[:new_capacity], atlas=atlas, tracks=tracks)

    def _ingest(self, chunks, final) -> PendingRound:
        st = self.state
        s_count = st.n_sensors
        if len(chunks) != s_count:
            raise ValueError(f"feed expects {s_count} per-sensor chunks, got {len(chunks)}")
        if isinstance(final, bool):
            final = np.full(s_count, final, bool)
        else:
            final = np.asarray(final, bool)
            if final.shape != (s_count,):
                raise ValueError(f"final mask must have shape ({s_count},), got {final.shape}")
        batcher = self.config.batcher
        merged_all, bounds_all, consumed_all = [], [], []
        # Phase A (fallible): validate and window every sensor before any
        # state changes, so a bad chunk rejects the whole feed.
        for s, (cur, chunk) in enumerate(zip(st.cursors, chunks)):
            x, y, t, p = _EMPTY_CHUNK if chunk is None else chunk
            merged = monotone_merge(cur.pending, x, y, t, p, cur.last_t, label=f"sensor {s}")
            if final[s]:
                bounds = dual_threshold_bounds(merged[2], batcher)
                consumed = len(merged[2])
            else:
                bounds, consumed = dual_threshold_closed_bounds(merged[2], batcher)
            merged_all.append(merged)
            bounds_all.append(bounds)
            consumed_all.append(consumed)
        n_valid = np.asarray([len(b) for b in bounds_all], np.int32)
        w_max = int(n_valid.max())
        if w_max > self._tag_limit:
            raise ValueError(
                f"feed closed {w_max} windows on one sensor, more than one "
                f"tag epoch ({self._tag_limit}) can address; split the feed"
            )

        # Phase B (infallible): pack every sensor into one staging set,
        # resolve tags and rollover, commit the cursors.
        cap = batcher.capacity
        ragged = self.wire == "ragged"
        staging = self._staging.acquire(s_count, w_max, cap, self.wire) if w_max else None
        wire_base = 0  # running write cursor into the shared wire lanes
        spill_blocks: list[np.ndarray] = []
        events_total = 0
        tag0 = np.zeros(s_count, np.int32)
        reset = np.zeros(s_count, bool)
        windows_list: list[WindowedEvents] = []
        for s, (cur, merged, bounds, consumed) in enumerate(
            zip(st.cursors, merged_all, bounds_all, consumed_all)
        ):
            mt = merged[2]
            n = len(bounds)
            bounds3 = [(a, b, int(mt[a])) for a, b in bounds]
            # Bookkeeping rows are fresh dense host planes: they stay
            # stable however soon the staging set is refilled.
            rows = [np.zeros((n, cap), np.int32) for _ in range(4)] + [np.zeros((n, cap), bool)]
            if ragged and staging is not None:
                starts, stops, t_start, overflow, wire_base, entries = pack_bounds_into(
                    *merged, bounds3,
                    out=(staging.words, staging.dt, staging.pbits, staging.offsets[s]),
                    layout="ragged", base=wire_base, capacity=cap,
                )
                if entries.shape[1]:
                    spill_blocks.append(entries)
                pack_bounds_into(*merged, bounds3, out=tuple(rows))
            elif staging is not None:
                planes = (*staging.packed[:, s], staging.valid[s])
                starts, stops, t_start, overflow = pack_bounds_into(*merged, bounds3, out=planes)
                rows = [a[:n].copy() for a in planes]
            else:
                starts, stops, t_start, overflow = pack_bounds_into(*merged, bounds3, out=tuple(rows))
            events_total += int(np.minimum(stops - starts, cap).sum())
            base = cur.events_consumed
            windows_list.append(WindowedEvents(
                EventBatch(*(torch.from_numpy(a) for a in rows)),
                t_start, starts + base, stops + base, overflow,
            ))
            t0 = cur.next_tag
            if t0 + w_max > self._tag_limit:  # tag epoch rollover
                reset[s], t0 = True, 0
            tag0[s] = t0
            cur.pending = tuple(a[consumed:] for a in merged)
            cur.events_consumed = base + consumed
            cur.next_tag = t0 + n
            cur.last_t = int(mt[-1]) if len(mt) else cur.last_t

        if w_max == 0:
            return PendingRound(FleetResult(
                n_windows=n_valid, windows=windows_list,
                clusters=None, metrics=None, tracks=None, final_tracks=None,
                _config=self.config, _with_tracking=self.with_tracking,
                _carry_tracks=st.tracks,
            ))

        staging.meta[0] = tag0
        staging.meta[1] = n_valid
        if ragged:
            n_pad = wire_pad(wire_base)
            m = sum(b.shape[1] for b in spill_blocks)
            m_pad = spill_pad(m)
            staging.reserve_spill(m_pad)
            spill_t = staging.spill_view(m_pad)
            # Re-sentinel the view every round: a stale entry from an
            # earlier round would overwrite live events in the decoder.
            spill_np = spill_t.numpy()
            spill_np[:] = SPILL_SENTINEL
            if m:
                spill_np[:, :m] = np.concatenate(spill_blocks, axis=1)
                self.wire_stats.spilled += m
            pack_polarity(staging.pbits[:wire_base], staging.pol)
            views = (staging.words_t[:n_pad], staging.dt_t[:n_pad],
                     staging.pol_t[: n_pad // 32], staging.offsets_t, spill_t)
            wire_b = ragged_wire_bytes(n_pad, s_count, w_max, m_pad)
        else:
            wire_b = dense_wire_bytes(s_count, w_max, cap)
        # The round's wire laid out as the carry (sensor_blocks): under a
        # mesh the hints put each block's rows, and one copy of the ragged
        # streams, on its device; without one they are the host buffers,
        # shipped whole to the pool's one block.
        surfaces = (dict(words=views[0], dt=views[1], pol=views[2], offsets=views[3], spill=views[4])
                    if ragged else dict(packed=staging.packed_t, valid=staging.valid_t))
        with use_mesh(self.mesh if self.mesh is not None and SENSOR_AXIS in self.mesh.axis_names else None):
            wire = hint_wire(meta=staging.meta_t, **surfaces)

        def part(name: str, coord, dev: torch.device) -> torch.Tensor:
            leaf = wire[name]
            if isinstance(leaf, Placed):
                return leaf.shard(coord)
            got = leaf.to(dev, non_blocking=True)
            # n_windows_t outlives the staging set: no alias on the CPU.
            return got.clone() if got is leaf and name == "meta" else got

        outs, metas, cards = [], [], []
        track_blocks = [sensor_blocks(a) for a in st.tracks]
        for b, (lo, hi, coord, atlas_in) in enumerate(sensor_blocks(st.atlas)):
            dev = atlas_in.device
            meta = part("meta", coord, dev)
            if reset[lo:hi].any():  # rare: tag-epoch rollover on some sensor(s)
                mask = torch.as_tensor(reset[lo:hi], device=dev)[:, None, None]
                atlas_in = torch.where(mask, 0, atlas_in)
            if ragged:
                with record_function("wire decode"):
                    packed_in, valid_in = self._wire(
                        *(part(k, coord, dev) for k in ("words", "dt", "pol", "offsets", "spill")), cap)
            else:
                packed_in, valid_in = part("packed", coord, dev), part("valid", coord, dev)
            tracks_in = TrackState(*(blocks[b][3] for blocks in track_blocks))
            outs.append(self._step(packed_in, valid_in, tracks_in, atlas_in, meta))
            metas.append(meta[1])
            if dev.type == "cuda" and dev not in cards:
                cards.append(dev)
        join = lambda parts: join_sensor_blocks(list(parts), st.atlas)  # noqa: E731
        joined = lambda tree_of: (  # noqa: E731
            None if outs[0][tree_of] is None else type(outs[0][tree_of])(
                *(join(p) for p in zip(*(o[tree_of] for o in outs)))))
        final_tracks, clusters, states = joined(0), joined(1), joined(3)
        mets = {k: join(o[2][k] for o in outs) for k in outs[0][2]}
        atlas = join(o[4] for o in outs)
        events = tuple(torch.cuda.Event() for _ in cards)
        for e, dev in zip(events, cards):
            e.record(torch.cuda.current_stream(dev))
        self.wire_stats.rounds += 1
        self.wire_stats.events += events_total
        self.wire_stats.wire_bytes += wire_b
        self.wire_stats.dense_bytes += dense_wire_bytes(s_count, w_max, cap)
        self.state = FleetState(cursors=st.cursors, atlas=atlas, tracks=final_tracks)
        pending = PendingRound(FleetResult(
            n_windows=n_valid, windows=windows_list,
            clusters=clusters, metrics=mets,
            tracks=states if self.with_tracking else None,
            final_tracks=final_tracks,
            _config=self.config, _with_tracking=self.with_tracking,
            _carry_tracks=final_tracks, _events=events, n_windows_t=join(metas),
        ))
        staging.inflight = pending
        return pending
