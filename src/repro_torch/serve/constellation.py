"""ConstellationService: many DetectionService shards on the card.

The port of ``repro.serve.constellation``. The paper positions the
detection stack as a building block for *distributed space surveillance
networks*; this module is that scale-out layer (DESIGN.md Sec. 15). A
:class:`ConstellationService` partitions sensor sessions across N
:class:`~repro_torch.serve.service.DetectionService` shards. Each shard
runs its own pipelined rounds on its device — shards at different
capacity tiers keep rounds in flight concurrently instead of the single
lock-step step a lone service dispatches.

Devices. ``devices=None`` takes every visible CUDA device and raises
when there is none; the CPU is used only when the caller passes
``devices=["cpu"]``. :func:`partition_devices` splits the devices over
the shards; with fewer devices than shards, shards share devices
round-robin, so N shards on one card is the reference's own
single-device layout (where it builds every shard without a mesh). A
shard group of one device runs the unsharded service on it; a group of
more than one gets a ``sensor`` mesh of its devices
(:func:`~repro_torch.launch.mesh.make_mesh`), over which its service's
fleet shards the carry, as the reference's per-shard meshes. The
reference also gives a group of one device a one-entry mesh when there
are several devices in all; that changes no result, so the port runs such
a group unsharded. A device listed more than once stands in for as many
devices: ``devices=["cuda"] * 4`` with two shards gives each shard a
two-entry mesh on the one card, and ``torch.device("cpu", i)`` entries
stand in for separate hosts.

Layered on top of the per-shard services:

* **Placement / rebalance planner.** ``attach`` routes a new sensor to
  the least-loaded up shard. Fault exits that free capacity (heartbeat
  eviction, tier demotion) trigger a rebalance sweep that re-migrates
  sessions from the most- to the least-loaded shard via the carry
  export/adopt path, which itself rides ``grow_fleet_carry`` /
  ``shrink_fleet_carry`` tier moves on either end. Migration preserves
  bit-identity: the slot carry IS the entire stream state.
* **Whole-shard rescue.** A shard whose fleet rounds keep failing
  (``rescue_after_degraded_rounds`` consecutive degraded rounds) is
  marked down and every session on it is re-migrated to the surviving
  shards — sessions are moved, not lost, because a degraded round
  restores its chunks to the session queues and the export carries
  queue + carry + stats across. ``revive_shard`` re-admits a repaired
  shard for new placements.
* **Compressed cross-shard exchange.** Every shard publishes a compact
  per-round summary plane (windows + valid clusters + per-metric sums
  per slot) through :class:`CrossShardExchange`, which quantizes the
  plane to int8 with an error-feedback buffer
  (:mod:`repro_torch.distributed.compression`) so the cross-shard wire
  cost is ~4x below fp32 while the running per-shard sums stay exact up
  to the final residual (the EF telescoping bound, pinned by tests).
  The plane and its round trip are small elementwise torch passes on
  the shard's device, queued on its stream: pushing never synchronizes.

Healthy-session outputs stay bit-identical to dedicated
:class:`~repro_torch.core.pipeline.stream.StreamingPipeline` runs on the
same device under any multi-shard churn — attach/feed/detach
interleavings, explicit migrations, rebalances, and whole-shard rescue
(pinned by ``tests/test_torch_constellation.py`` and the shard chaos
harness in :mod:`repro_torch.serve.chaos_shards`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy
import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.fleet import DEFAULT_TIERS, PendingRound, WireStats
from repro_torch.core.pipeline.scan import ScanResult
from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.distributed.sharding import SENSOR_AXIS, assemble
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.batcher import AdmissionConfig
from repro_torch.serve.faults import FaultConfig
from repro_torch.serve.service import DetectionService, ServedFeed
from repro_torch.serve.sessions import LIVE, SensorSession

EXCHANGE_MODES = ("int8_ef", "exact", "off")


def partition_devices(devices, n_shards: int) -> list[tuple]:
    """Split ``devices`` into ``n_shards`` per-shard groups.

    With at least one device per shard the split is contiguous and
    balanced (first ``len % n`` shards get the extra device) so each
    shard's group is a compact slice of the device order. With fewer
    devices than shards, shards share devices round-robin — the
    simulated multi-host shape on small hosts.
    """
    devices = list(devices)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not devices:
        raise ValueError("need at least one device")
    if len(devices) < n_shards:
        return [(devices[i % len(devices)],) for i in range(n_shards)]
    base, extra = divmod(len(devices), n_shards)
    groups, at = [], 0
    for i in range(n_shards):
        n = base + (1 if i < extra else 0)
        groups.append(tuple(devices[at : at + n]))
        at += n
    return groups


def _resolve_devices(devices) -> list[torch.device]:
    """The shards' devices: every visible CUDA device by default (raising
    when there is none), else the caller's, each resolved (``"cuda"``
    names the current CUDA device, so two spellings of one card are one
    device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ConstellationService places its shards on the visible CUDA devices "
                "and torch.cuda.is_available() is False; pass devices=['cpu'] to run "
                "on the CPU"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out


def _summary_fn(valid, n_valid, *mets) -> torch.Tensor:
    """Per-round summary plane: (S, 2 + n_metrics) float32 on the round's
    device.

    Column 0 is each slot's real window count this round, column 1 its
    valid-cluster count, and the rest the per-metric sums over valid
    clusters in real windows — the compact per-slot digest a fusion /
    catalog consumer wants from every remote shard each round. Padded
    windows and invalid cluster rows contribute exactly zero. The counts
    are exact; the metric sums are float32 reductions whose order is
    torch's, not XLA's.
    """
    wmask = torch.arange(valid.shape[1], device=valid.device)[None, :] < n_valid[:, None]
    cmask = valid & wmask[:, :, None]
    cols = [n_valid.to(torch.float32), cmask.sum(dim=(1, 2)).to(torch.float32)]
    for m in mets:
        cols.append(torch.where(cmask, m.to(torch.float32), 0.0).sum(dim=(1, 2)))
    return torch.stack(cols, dim=1)


def _compress_fn(plane: torch.Tensor, ef: torch.Tensor):
    """EF-int8 round trip for one plane: (q, scale, deq, ef').

    The reference runs this under ``jax.jit``, so its scale is
    ``amax * f32(1/127)`` (``quantize_int8(jit_scale=True)``) and XLA
    contracts ``corrected - q * scale`` into one fused multiply-add. The
    residual here is that single rounding, computed exactly in float64
    (``q * scale`` and the difference are exact there) and rounded once
    to float32, the same on every device."""
    corrected = plane + ef
    q, scale = quantize_int8(corrected, jit_scale=True)
    deq = dequantize_int8(q, scale)
    resid = (corrected.double() - q.double() * scale.double()).to(torch.float32)
    return q, scale, deq, resid


class CrossShardExchange:
    """Compressed per-round result-plane exchange between shards.

    Each shard pushes its round's summary plane
    (:func:`_summary_fn`); peers read the latest published plane per
    shard via :meth:`latest`. In ``"int8_ef"`` mode the plane crosses
    the (simulated) wire as int8 + one fp32 scale — ~4x fewer bytes
    than fp32 — with a per-shard error-feedback buffer carrying the
    quantization residual into the next round, so:

    * per round: ``|deq - (plane + ef_prev)| <= scale / 2`` elementwise
      (symmetric int8 round-to-nearest, unsaturated by construction
      since the scale is the per-tensor absmax / 127), and
    * telescoping: the sum of published planes equals the sum of exact
      planes minus the final EF residual — running cross-shard
      accumulations are exact up to one round's quantization error.

    ``"exact"`` publishes fp32 planes (the oracle the tests compare
    against); ``"off"`` publishes nothing. Pushing never synchronizes
    with the device — planes stay device tensors, queued behind the
    round on its stream, until read; ``wire_bytes`` is shape arithmetic —
    so the exchange cannot serialize the shards' interleaved rounds.
    """

    def __init__(self, n_shards: int, mode: str = "int8_ef"):
        if mode not in EXCHANGE_MODES:
            raise ValueError(
                f"exchange mode must be one of {EXCHANGE_MODES}, got {mode!r}"
            )
        self.n_shards = n_shards
        self.mode = mode
        self.columns: tuple[str, ...] | None = None  # set at first push
        self.rounds = 0
        self.wire_bytes = 0  # bytes a compressed link would carry
        self.exact_bytes = 0  # bytes the fp32 link would carry
        self._latest: list = [None] * n_shards  # published plane (lazy)
        self._ef: list = [None] * n_shards  # error-feedback carry (lazy)
        self._scale: list = [None] * n_shards  # last round's quant scale

    @staticmethod
    def summary_plane(round_: PendingRound) -> torch.Tensor | None:
        """The exact (uncompressed) summary plane for one fleet round —
        ``None`` when the round closed no window. Public so tests and
        consumers can compare published planes against the oracle."""
        res = round_.result()
        if res.clusters is None:
            return None
        # Under a shard mesh the leaves are sensor blocks: the plane is
        # made from them assembled on the mesh's first device.
        return _summary_fn(
            assemble(res.clusters.valid),
            assemble(res.n_windows_t),
            *[assemble(res.metrics[k]) for k in sorted(res.metrics)],
        )

    def push_round(self, shard: int, round_: PendingRound) -> None:
        """Publish one shard's round. No-op in ``"off"`` mode or when
        the round closed no window (nothing to exchange)."""
        if self.mode == "off":
            return
        res = round_.result()
        if res.clusters is None:
            return
        if self.columns is None:
            self.columns = ("windows", "clusters") + tuple(sorted(res.metrics))
        plane = self.summary_plane(round_)
        self.rounds += 1
        self.exact_bytes += plane.numel() * 4
        if self.mode == "exact":
            self.wire_bytes += plane.numel() * 4
            self._latest[shard] = plane
            return
        ef = self._ef[shard]
        if ef is None or ef.shape != plane.shape:
            # Tier promotion/demotion resized the slot pool: grow appends
            # slots and shrink drops the free tail, so surviving rows
            # keep their residual and new rows start clean.
            fresh = torch.zeros(plane.shape, dtype=torch.float32, device=plane.device)
            if ef is not None:
                keep = min(ef.shape[0], plane.shape[0])
                fresh[:keep] = ef[:keep]
            ef = fresh
        q, scale, deq, ef = _compress_fn(plane, ef)
        self.wire_bytes += q.numel() + 4  # int8 payload + one fp32 scale
        self._latest[shard] = deq
        self._ef[shard] = ef
        self._scale[shard] = scale

    def latest(self, shard: int) -> numpy.ndarray | None:
        """Most recently published plane for ``shard`` (host fp32), as a
        peer would decode it — dequantized in ``"int8_ef"`` mode."""
        p = self._latest[shard]
        return None if p is None else p.cpu().numpy()

    def error_feedback(self, shard: int) -> numpy.ndarray | None:
        """Current EF residual for ``shard`` (None before any push)."""
        e = self._ef[shard]
        return None if e is None else e.cpu().numpy()

    def last_scale(self, shard: int) -> float | None:
        """Quantization scale of ``shard``'s last published round."""
        s = self._scale[shard]
        return None if s is None else float(s)

    def view(self) -> dict[int, numpy.ndarray]:
        """All published planes, keyed by shard index."""
        out = {}
        for i in range(self.n_shards):
            p = self.latest(i)
            if p is not None:
                out[i] = p
        return out

    @property
    def stats(self) -> dict:
        return {
            "mode": self.mode,
            "rounds": self.rounds,
            "wire_bytes": self.wire_bytes,
            "exact_bytes": self.exact_bytes,
            "compression_ratio": (
                self.exact_bytes / self.wire_bytes if self.wire_bytes else 0.0
            ),
        }


@dataclasses.dataclass
class ConstellationFeed:
    """One session's share of one shard's fleet round, globally keyed."""

    gid: int  # constellation-global session id
    shard: int  # shard that served it
    feed: ServedFeed

    @property
    def num_windows(self) -> int:
        return self.feed.num_windows

    @property
    def latency_ms(self) -> float:
        return self.feed.latency_ms

    @property
    def result(self) -> ScanResult:
        return self.feed.result


@dataclasses.dataclass
class _Shard:
    """One shard's runtime record: the service, its device group and its
    ``sensor`` mesh (``None`` for a group of one device), and the
    constellation-side bookkeeping layered on it."""

    index: int
    service: DetectionService
    devices: tuple
    mesh: object | None = None
    down: bool = False
    # Local sid -> global id for constellation-live sessions only;
    # entries leave when the session migrates or a local fault closes it.
    local_to_global: dict[int, int] = dataclasses.field(default_factory=dict)
    # Fault-counter checkpoints (deltas drive rebalance/rescue triggers).
    degraded_seen: int = 0
    evictions_seen: int = 0
    demotions_seen: int = 0
    consecutive_degraded: int = 0
    pushed_round: object | None = None  # last round handed to the exchange

    @property
    def load(self) -> int:
        return self.service.n_sessions


class ConstellationService:
    """Sharded detection serving: sessions partitioned over N shards.

    >>> cs = ConstellationService(PipelineConfig(), n_shards=2)  # on the card
    >>> gid = cs.attach("station-7")     # routed to the least-loaded shard
    >>> done = cs.feed(gid, x, y, t, p)  # [] until that shard admits
    >>> done = cs.pump(force=True)       # one round on EVERY up shard
    >>> tail = cs.detach(gid)

    Every shard is a full :class:`DetectionService` over its own fleet
    (own admitter, own slot pool, own capacity tier, own device), so a
    constellation ``pump`` dispatches up to N rounds that
    execute concurrently — each shard's ``max_inflight_rounds`` depth
    (default 2 here) lets its next round's host packing overlap its
    previous round's device compute, and nothing in the constellation
    layer synchronizes between shard dispatches.

    Global session ids (``gid``) are stable across migration: the
    constellation owns the gid -> (shard, local sid) routing table and
    re-points it when a session moves, so callers never see the hop
    (beyond their stream continuing bit-identically on a new shard).

    ``rescue_after_degraded_rounds=None`` (default) disables whole-shard
    rescue; deployments with ``faults.degrade_on_step_failure`` set it
    to bound how long a stalled shard can hold its sessions hostage.

    ``devices`` are torch devices (or their names), split over the shards
    by :func:`partition_devices`; ``None`` is every visible CUDA device.
    """

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        n_shards: int = 2,
        tiers: tuple[int, ...] = DEFAULT_TIERS,
        admission: AdmissionConfig = AdmissionConfig(),
        faults: FaultConfig = FaultConfig(),
        with_tracking: bool = True,
        devices=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        max_inflight_rounds: int = 2,
        exchange: str = "int8_ef",
        rebalance_margin: int = 2,
        auto_rebalance: bool = True,
        rescue_after_degraded_rounds: int | None = None,
        wire: str = "ragged",
    ):
        if rebalance_margin < 1:
            raise ValueError(
                f"rebalance_margin must be >= 1, got {rebalance_margin}"
            )
        self.config = config
        self.clock = clock
        self.rebalance_margin = rebalance_margin
        self.auto_rebalance = auto_rebalance
        self.rescue_after_degraded_rounds = rescue_after_degraded_rounds
        groups = partition_devices(_resolve_devices(devices), n_shards)
        self._shards: list[_Shard] = []
        for i, group in enumerate(groups):
            mesh = make_mesh((len(group),), (SENSOR_AXIS,), devices=group) if len(group) > 1 else None
            self._shards.append(_Shard(
                index=i,
                service=DetectionService(
                    config,
                    tiers=tiers,
                    admission=admission,
                    faults=faults,
                    with_tracking=with_tracking,
                    mesh=mesh,
                    clock=clock,
                    sleep=sleep,
                    max_inflight_rounds=max_inflight_rounds,
                    wire=wire,
                    device=group[0],
                ),
                devices=group,
                mesh=mesh,
            ))
        self.exchange = CrossShardExchange(n_shards, exchange)
        self._routes: dict[int, tuple[int, int]] = {}  # gid -> (shard, lsid)
        self._closed: dict[int, tuple[int, int]] = {}  # gid -> last home
        self._next_gid = 0
        self.migrations = 0  # sessions moved between shards
        self.rebalances = 0  # rebalance sweeps that moved >= 1 session
        self.rescues = 0  # whole-shard rescues performed
        self._want_rebalance = False

    # ------------------------------------------------------------------
    # Introspection.
    # ------------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def n_sessions(self) -> int:
        """Constellation-live sessions across all shards."""
        return len(self._routes)

    @property
    def wire_stats(self):
        """Aggregate ingest transfer accounting over every shard's fleet
        (``WireStats`` — see :class:`~repro_torch.serve.service.DetectionService`)."""
        total = WireStats()
        for shard in self._shards:
            total.add(shard.service.wire_stats)
        return total

    @property
    def capacity(self) -> int:
        """Total slot-pool capacity across shards (sum of active tiers)."""
        return sum(sh.service.capacity for sh in self._shards)

    @property
    def loads(self) -> list[int]:
        """Live sessions per shard (placement-planner view)."""
        return [sh.load for sh in self._shards]

    @property
    def down_shards(self) -> list[int]:
        return [sh.index for sh in self._shards if sh.down]

    def shard(self, i: int) -> _Shard:
        """Shard runtime record (service, devices, mesh, fault deltas)."""
        return self._shards[i]

    def shard_of(self, gid: int) -> int:
        """Which shard currently (or last) hosts ``gid``."""
        home = self._routes.get(gid) or self._closed.get(gid)
        if home is None:
            raise KeyError(f"unknown session id {gid}")
        return home[0]

    def session(self, gid: int) -> SensorSession:
        """The session record (any state), wherever it lives now."""
        home = self._routes.get(gid) or self._closed.get(gid)
        if home is None:
            raise KeyError(f"unknown session id {gid}")
        return self._shards[home[0]].service.session(home[1])

    def backlog(self, gid: int) -> int:
        shard_i, lsid = self._route(gid)
        return self._shards[shard_i].service.backlog(lsid)

    def stats(self) -> dict:
        """Operator snapshot: planner counters, per-shard state, exchange."""
        return {
            "n_sessions": self.n_sessions,
            "capacity": self.capacity,
            "migrations": self.migrations,
            "rebalances": self.rebalances,
            "rescues": self.rescues,
            "shards": [
                {
                    "index": sh.index,
                    "down": sh.down,
                    "sessions": sh.load,
                    "capacity": sh.service.capacity,
                    "devices": [str(d) for d in sh.devices],
                    "degraded_rounds": sh.service.degraded_rounds,
                    "evictions": sh.service.evictions,
                    "quarantines": sh.service.quarantines,
                    "inflight_rounds": sh.service.inflight_rounds,
                }
                for sh in self._shards
            ],
            "exchange": self.exchange.stats,
        }

    # ------------------------------------------------------------------
    # Lifecycle.
    # ------------------------------------------------------------------

    def attach(self, name: str | None = None) -> int:
        """Admit a new sensor on the least-loaded up shard; returns its
        constellation-global session id."""
        shard = self._pick_shard()
        gid = self._next_gid
        self._next_gid += 1
        lsid = shard.service.attach(name or f"sensor-{gid}")
        self._routes[gid] = (shard.index, lsid)
        shard.local_to_global[lsid] = gid
        return gid

    def feed(self, gid: int, x, y, t, p) -> list[ConstellationFeed]:
        """Queue one chunk for ``gid`` on its shard; that shard steps if
        its admission fires. Returns the feeds completed by this call
        (the owning shard's round only — other shards step on their own
        admission clocks or on :meth:`pump`)."""
        shard_i, lsid = self._route(gid)
        shard = self._shards[shard_i]
        feeds = shard.service.feed(lsid, x, y, t, p)
        out = self._wrap(shard, feeds)
        self._after_round(shard, bool(feeds))
        self._maybe_rescue()
        self._flush_rebalance()
        return out

    def pump(self, force: bool = False) -> list[ConstellationFeed]:
        """One round on every up shard (admission-gated unless ``force``).

        Shards dispatch in index order without synchronizing between
        dispatches: with pipeline depth > 1 every shard's round is in
        flight before the first one's results are consumed, which is
        the constellation's concurrency model on one host. Follows up
        with fault reconciliation, whole-shard rescue, and any pending
        fault-triggered rebalance."""
        out: list[ConstellationFeed] = []
        for shard in self._shards:
            if shard.down:
                continue
            feeds = shard.service.pump(force=force)
            out.extend(self._wrap(shard, feeds))
            self._after_round(shard, bool(feeds))
        self._maybe_rescue()
        self._flush_rebalance()
        return out

    def drain(self) -> None:
        """Retire every in-flight round on every up shard."""
        for shard in self._shards:
            if not shard.down:
                shard.service.drain()

    def detach(self, gid: int) -> ScanResult:
        """Close ``gid`` wherever it lives: flush + recycle on its shard,
        return the tail result."""
        shard_i, lsid = self._route(gid)
        shard = self._shards[shard_i]
        out = shard.service.detach(lsid)
        del shard.local_to_global[lsid]
        del self._routes[gid]
        self._closed[gid] = (shard_i, lsid)
        return out

    def forget(self, gid: int) -> None:
        """Drop a closed session's record (here and on its last shard)."""
        home = self._closed.pop(gid, None)
        if home is None:
            if gid in self._routes:
                raise RuntimeError(f"session {gid} is live; detach first")
            return
        self._shards[home[0]].service.forget(home[1])

    # ------------------------------------------------------------------
    # Placement / rebalance planner (DESIGN.md Sec. 15).
    # ------------------------------------------------------------------

    def migrate(self, gid: int, dst: int) -> None:
        """Move one live session to shard ``dst`` via carry export/adopt.

        The stream resumes bit-identically on the destination (the slot
        carry is the entire stream state); queued chunks, the latency
        clock, and the stats record travel with it. The gid is stable —
        only the routing table changes."""
        shard_i, lsid = self._route(gid)
        src = self._shards[shard_i]
        dst_shard = self._shards[dst]
        if dst_shard.down:
            raise RuntimeError(f"shard {dst} is down")
        if dst_shard is src:
            return
        export = src.service.export_session(lsid)
        del src.local_to_global[lsid]
        new_lsid = dst_shard.service.adopt_session(export)
        self._routes[gid] = (dst, new_lsid)
        dst_shard.local_to_global[new_lsid] = gid
        self.migrations += 1

    def rebalance(self, max_moves: int | None = None) -> int:
        """Re-migrate sessions from the most- to the least-loaded up
        shard until the spread is within ``rebalance_margin`` (or
        ``max_moves`` moves were made). Returns the number of moves."""
        moves = 0
        while max_moves is None or moves < max_moves:
            up = [sh for sh in self._shards if not sh.down]
            if len(up) < 2:
                break
            hi = max(up, key=lambda s: (s.load, -s.index))
            lo = min(up, key=lambda s: (s.load, s.index))
            if hi.load - lo.load <= self.rebalance_margin:
                break
            # Youngest local session moves: oldest streams keep their
            # warm placement, and the youngest has the least state.
            lsid = max(hi.local_to_global)
            self.migrate(hi.local_to_global[lsid], lo.index)
            moves += 1
        if moves:
            self.rebalances += 1
        return moves

    def rescue_shard(self, i: int) -> int:
        """Mark shard ``i`` down and re-migrate every session it holds
        to the surviving shards (least-loaded first). Returns the number
        of sessions moved. Raises when no other shard is up — there is
        nowhere to move the streams, and marking the only shard down
        would strand them."""
        shard = self._shards[i]
        others = [s for s in self._shards if s is not shard and not s.down]
        if not others:
            raise RuntimeError(
                f"cannot rescue shard {i}: no other shard is up"
            )
        moved = 0
        for lsid in sorted(shard.local_to_global):
            gid = shard.local_to_global[lsid]
            dst = min(others, key=lambda s: (s.load, s.index))
            self.migrate(gid, dst.index)
            moved += 1
        shard.down = True
        self.rescues += 1
        return moved

    def revive_shard(self, i: int) -> None:
        """Re-admit a repaired shard for new placements (existing
        sessions stay where the rescue put them)."""
        shard = self._shards[i]
        shard.down = False
        shard.consecutive_degraded = 0
        shard.degraded_seen = shard.service.degraded_rounds

    # ------------------------------------------------------------------
    # Internals.
    # ------------------------------------------------------------------

    def _route(self, gid: int) -> tuple[int, int]:
        home = self._routes.get(gid)
        if home is None:
            if gid in self._closed:
                state = self.session(gid).state
                raise RuntimeError(f"session {gid} is {state}")
            raise KeyError(f"unknown session id {gid}")
        return home

    def _pick_shard(self) -> _Shard:
        up = [sh for sh in self._shards if not sh.down]
        if not up:
            raise RuntimeError("every shard is down; revive one first")
        return min(up, key=lambda s: (s.load, s.index))

    def _wrap(
        self, shard: _Shard, feeds: list[ServedFeed]
    ) -> list[ConstellationFeed]:
        return [
            ConstellationFeed(
                gid=shard.local_to_global[f.sid], shard=shard.index, feed=f
            )
            for f in feeds
        ]

    def _after_round(self, shard: _Shard, served: bool) -> None:
        """Post-round bookkeeping for one shard: reconcile local fault
        exits into the routing table, track degraded streaks, schedule
        fault-triggered rebalances, publish to the exchange."""
        svc = shard.service
        # Local faults (quarantine / heartbeat eviction) close sessions
        # inside the shard; re-point their global routes to "closed".
        for lsid, gid in list(shard.local_to_global.items()):
            if svc.session(lsid).state != LIVE:
                del shard.local_to_global[lsid]
                del self._routes[gid]
                self._closed[gid] = (shard.index, lsid)
        delta = svc.degraded_rounds - shard.degraded_seen
        if delta > 0:
            shard.degraded_seen = svc.degraded_rounds
            shard.consecutive_degraded += delta
        elif served:
            shard.consecutive_degraded = 0
        # Fault exits that freed capacity re-trigger the planner.
        if (
            svc.evictions != shard.evictions_seen
            or svc.demotions != shard.demotions_seen
        ):
            shard.evictions_seen = svc.evictions
            shard.demotions_seen = svc.demotions
            self._want_rebalance = True
        rnd = svc.last_round
        if rnd is not None and rnd is not shard.pushed_round:
            self.exchange.push_round(shard.index, rnd)
            shard.pushed_round = rnd

    def _maybe_rescue(self) -> None:
        if self.rescue_after_degraded_rounds is None:
            return
        for shard in self._shards:
            if (
                not shard.down
                and shard.consecutive_degraded
                >= self.rescue_after_degraded_rounds
                and any(
                    s is not shard and not s.down for s in self._shards
                )
            ):
                self.rescue_shard(shard.index)

    def _flush_rebalance(self) -> None:
        if self._want_rebalance and self.auto_rebalance:
            self._want_rebalance = False
            self.rebalance()
