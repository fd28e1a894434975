"""DetectionService: dynamic sensor sessions over the slot-pooled fleet.

The port of ``repro.serve.service``, the serving top of the detection
stack. Sensors attach and detach at will; every attached session feeds
raw event chunks at its own cadence; the service micro-batches the
queued chunks under the paper's dual-threshold admission policy
(:mod:`repro_torch.serve.batcher`) and drives the whole set through ONE
slot-pooled :class:`~repro_torch.core.pipeline.fleet.FleetPipeline` step
on the service's device.

Contracts:

* **Bit-identity.** Every session's results, concatenated over its
  lifetime, including the detach tail, equal those of a dedicated
  :class:`~repro_torch.core.pipeline.stream.StreamingPipeline` on the
  same device fed the same chunks, for any interleaving of attach /
  feed / idle / detach across sessions, including slot recycling and
  capacity-tier promotion and demotion mid-stream.
* **Fault isolation.** Faults on one sensor never perturb another: with
  :class:`~repro_torch.serve.faults.FaultConfig` degraded modes enabled,
  a corrupt chunk quarantines only the offending session, a silent
  sensor is evicted by heartbeat deadline (slot flushed + recycled), an
  overloaded session sheds by its own queue budget, and a failed fleet
  step retries with backoff before the round is marked degraded with
  every taken chunk restored.
* **Atomic validation.** A chunk that is out of order, within itself or
  against its session's stream, or carries int32-unsafe garbage
  coordinates is refused at the ``feed`` call, before it is queued: no
  other session's state is touched. Under the strict default it raises
  ``ValueError``; under ``on_validation_error="quarantine"`` the
  offending session, and only it, is quarantined with a structured error
  record and its slot recycled.
* **Migration.** :meth:`DetectionService.export_session` lifts a live
  session out with its complete state and
  :meth:`DetectionService.adopt_session` resumes it in another service
  of the same config, on either device; :func:`session_export_to_numpy`
  and :func:`session_export_from_numpy` carry it as plain numpy, so a
  session also moves to and from the reference's service.
"""
from __future__ import annotations

import bisect
import copy
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.fleet import (
    DEFAULT_TIERS,
    FleetPipeline,
    PendingRound,
    SlotCarry,
    slot_carry_from_numpy,
    slot_carry_to_numpy,
    tier_capacity,
)
from repro_torch.core.pipeline.scan import ScanResult
from repro_torch.serve.batcher import AdmissionConfig, DualThresholdAdmitter
from repro_torch.serve.faults import FaultConfig, SessionHealth
from repro_torch.serve.sessions import (
    DETACHED,
    EVICTED,
    LIVE,
    MIGRATED,
    QUARANTINED,
    SensorSession,
    SessionError,
    SessionStats,
)


@dataclasses.dataclass
class ServedFeed:
    """One session's share of one fleet step.

    ``result`` is lazy: the fleet round behind it was dispatched
    asynchronously, and the per-sensor :class:`ScanResult` materializes
    (synchronizing with the device if needed) the first time it is read.
    Consuming several feeds from several in-flight rounds together costs
    one sync, not one per round. Everything else (``sid``,
    ``latency_ms``, ``num_windows``) is host data, readable without
    blocking.
    """

    sid: int
    latency_ms: float  # oldest queued chunk's arrival -> round dispatched
    _round: PendingRound = dataclasses.field(repr=False)
    _slot: int = dataclasses.field(repr=False)
    _result: ScanResult | None = dataclasses.field(default=None, repr=False)

    @property
    def num_windows(self) -> int:
        """Windows this step closed for the session (never blocks)."""
        return int(self._round.n_windows[self._slot])

    @property
    def result(self) -> ScanResult:
        """The session's trimmed result (materializes on first read)."""
        if self._result is None:
            self._result = self._round.result().sensor(self._slot)
        return self._result


@dataclasses.dataclass
class SessionExport:
    """One session's complete portable state (session migration).

    Produced by :meth:`DetectionService.export_session`, consumed by
    :meth:`DetectionService.adopt_session` on any service sharing the
    same :class:`~repro_torch.core.pipeline.config.PipelineConfig`, on
    either device. Carries
    the fleet slot carry (the entire device-side stream state), the
    unstepped ingest queue with original arrival stamps, the monotone
    watermark, and the session's accumulated stats/error records — so
    the adopted stream resumes bit-identically and the operator-facing
    accounting survives the hop.
    """

    name: str
    carry: SlotCarry
    queue: list  # [(chunk, arrival_s)] in arrival order
    last_t: int | None
    stats: SessionStats
    errors: list[SessionError]

    @property
    def queued_events(self) -> int:
        return sum(len(c[2]) for c, _ in self.queue)


def session_export_to_numpy(export: SessionExport) -> dict:
    """The export as plain numpy and Python values: ``name``, ``carry``
    (:func:`~repro_torch.core.pipeline.fleet.slot_carry_to_numpy`),
    ``queue`` (``[((x, y, t, p) int64 arrays, arrival_s)]``), ``last_t``,
    ``stats`` (the :class:`SessionStats` fields) and ``errors`` (each
    :class:`SessionError`'s fields): the fields of the reference's
    ``SessionExport``, so a session crosses between the packages."""
    return dict(
        name=export.name,
        carry=slot_carry_to_numpy(export.carry),
        queue=[(tuple(np.array(a, np.int64) for a in c), float(arr)) for c, arr in export.queue],
        last_t=None if export.last_t is None else int(export.last_t),
        stats=copy.deepcopy(dataclasses.asdict(export.stats)),
        errors=[dataclasses.asdict(e) for e in export.errors],
    )


def session_export_from_numpy(d: dict) -> SessionExport:
    """A :class:`SessionExport` from the form :func:`session_export_to_numpy`
    gives, e.g. built field by field from the reference's export."""
    return SessionExport(
        name=str(d["name"]),
        carry=slot_carry_from_numpy(d["carry"]),
        queue=[(tuple(np.array(a, np.int64) for a in c), float(arr)) for c, arr in d["queue"]],
        last_t=None if d["last_t"] is None else int(d["last_t"]),
        stats=SessionStats(**copy.deepcopy(d["stats"])),
        errors=[SessionError(**e) for e in d["errors"]],
    )


class DetectionService:
    """Micro-batched detection serving over a slot pool of sensor sessions.

    >>> svc = DetectionService(PipelineConfig(), tiers=(4, 8), device="cuda")
    >>> sid = svc.attach("station-7")
    >>> done = svc.feed(sid, x, y, t, p)   # [] until admission fires
    >>> done = svc.pump(force=True)        # or step the fleet explicitly
    >>> tail = svc.detach(sid)             # flush + recycle the slot

    ``feed`` queues the (validated) chunk and steps the fleet only when
    the admission policy fires — oldest queued chunk ``max_delay_s`` old
    OR ``max_items`` events queued fleet-wide — so concurrent sessions
    share one fleet step instead of paying one each. The returned
    list carries every session's results from that step, not just the
    caller's. ``pump(force=True)`` steps unconditionally (deterministic
    drivers, tests, drain-before-shutdown).

    ``faults`` selects the degraded modes: the default
    :class:`FaultConfig` is the strict contract above; a fault-tolerant
    deployment passes quarantine / queue budgets / heartbeat eviction /
    step-retry policies explicitly. ``sleep`` is the retry-backoff
    sleeper (injectable so tests never really sleep).

    ``max_inflight_rounds`` is the ingest pipeline depth. The default 1
    is the synchronous path: every round is awaited before ``_step``
    returns. Depth N > 1 keeps up to N dispatched rounds in flight on the
    device's stream —
    host packing of the next round overlaps device compute of the
    previous ones — and an admission-triggered round arriving while the
    pipeline is full is *deferred* (queues intact, admission state
    untouched, per-session ``deferred_rounds`` incremented) rather than
    blocking the feed caller; ``pump(force=True)`` and detach/evict
    flushes instead apply backpressure by retiring the oldest round.
    Outputs are bit-identical at every depth for any chunking/churn
    schedule.

    ``wire`` selects the host->device ingest format (``"ragged"`` — the
    compressed event wire, the default — or ``"dense"``); outputs are
    bit-identical either way and per-round transfer sizes accumulate in
    :attr:`wire_stats`. ``device`` is where the fleet runs: the card
    unless the caller asks for the CPU. ``mesh`` (a mesh of devices with
    a ``sensor`` axis) is passed to the fleet, which then shards its slot
    pool over the mesh's devices and does not use ``device``.
    """

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        tiers: tuple[int, ...] = DEFAULT_TIERS,
        admission: AdmissionConfig = AdmissionConfig(),
        faults: FaultConfig = FaultConfig(),
        with_tracking: bool = True,
        mesh=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        max_inflight_rounds: int = 1,
        wire: str = "ragged",
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if not tiers or list(tiers) != sorted(set(tiers)):
            raise ValueError(f"tiers must be strictly increasing, got {tiers}")
        if max_inflight_rounds < 1:
            raise ValueError(
                f"max_inflight_rounds must be >= 1, got {max_inflight_rounds}"
            )
        self.config = config
        self.tiers = tuple(int(t) for t in tiers)
        self.faults = faults
        self.clock = clock
        self._sleep = sleep
        self.max_inflight_rounds = max_inflight_rounds
        self._admit: DualThresholdAdmitter[int] = DualThresholdAdmitter(
            admission, clock
        )
        self._health = SessionHealth(faults, clock)
        # The reference also passes uniform_fast_path=False here, to keep
        # its fleet step at one compile per capacity tier; PyTorch
        # compiles nothing, and the port's fleet has no such variant.
        self._fleet = FleetPipeline(
            config,
            n_sensors=self.tiers[0],
            with_tracking=with_tracking,
            mesh=mesh,
            # One spare staging set beyond the deepest in-flight window,
            # so packing round N never waits on a buffer still borrowed
            # by an unretired round.
            staging_depth=max(2, max_inflight_rounds),
            wire=wire,
            device=device,
        )
        self.device = self._fleet.device
        self._sessions: dict[int, SensorSession] = {}  # all states
        self._by_slot: dict[int, int] = {}  # slot -> sid, live only
        self._free: list[int] = list(range(self.tiers[0]))  # sorted
        self._inflight: list[PendingRound] = []  # dispatched, unretired
        self._next_sid = 0
        self.promotions = 0  # capacity-tier promotions performed
        self.demotions = 0  # capacity-tier demotions performed
        self.quarantines = 0  # sessions quarantined (validation faults)
        self.evictions = 0  # sessions evicted (heartbeat deadline)
        self.degraded_rounds = 0  # fleet rounds failed + restored
        self.step_retries = 0  # fleet step retries performed
        self.deferred_rounds = 0  # admission rounds deferred, pipeline full
        self.errors: list[SessionError] = []  # service-wide fault log
        # Most recently dispatched fleet round (a monitoring tap; never
        # consumed by the service itself).
        self.last_round: PendingRound | None = None

    # ------------------------------------------------------------------
    # Introspection.
    # ------------------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Current slot-pool capacity (the active tier)."""
        return self._fleet.n_sensors

    @property
    def wire_stats(self):
        """Ingest transfer accounting (``WireStats``): bytes shipped per
        round on the active wire mode vs the dense-equivalent cost."""
        return self._fleet.wire_stats

    @property
    def n_sessions(self) -> int:
        """Live (attached) sessions."""
        return len(self._by_slot)

    def session(self, sid: int) -> SensorSession:
        """Session record (any state) — stats, slot, errors."""
        return self._sessions[sid]

    def backlog(self, sid: int) -> int:
        """Events accepted for ``sid`` but not yet windowed: the service
        queue plus the slot's batcher remainder inside the fleet carry."""
        sess = self._sessions[sid]
        queued = sess.queued_events
        if sess.state == LIVE:
            queued += self._fleet.state.cursors[sess.slot].pending_count
        return queued

    def _sids_in(self, state: str) -> list[int]:
        return [sid for sid, s in self._sessions.items() if s.state == state]

    @property
    def detached_sessions(self) -> list[int]:
        """Sids of retained detached-session records (see :meth:`forget`)."""
        return self._sids_in(DETACHED)

    @property
    def migrated_sessions(self) -> list[int]:
        """Sids exported to another service (records retained)."""
        return self._sids_in(MIGRATED)

    @property
    def quarantined_sessions(self) -> list[int]:
        """Sids quarantined by validation faults (records retained)."""
        return self._sids_in(QUARANTINED)

    @property
    def evicted_sessions(self) -> list[int]:
        """Sids evicted by heartbeat deadline (records retained)."""
        return self._sids_in(EVICTED)

    def stragglers(self) -> list[int]:
        """Live sids whose service-latency EMA exceeds the straggler
        threshold (flagged, not evicted — see FaultConfig)."""
        return [s for s in self._health.stragglers() if s in self._by_slot.values()]

    # ------------------------------------------------------------------
    # Lifecycle.
    # ------------------------------------------------------------------

    def attach(self, name: str | None = None) -> int:
        """Admit a new sensor; returns its session id.

        Takes the lowest free slot; with no slot free, promotes the pool
        to the next capacity tier first (carry migration — live sessions
        are unaffected, their results stay bit-identical across the
        promotion).
        """
        if not self._free:
            new_cap = tier_capacity(self.capacity + 1, self.tiers)
            old_cap = self.capacity
            self._fleet.grow(new_cap)
            self._free.extend(range(old_cap, new_cap))
            self.promotions += 1
        slot = self._free.pop(0)
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = SensorSession(
            sid=sid,
            slot=slot,
            name=name or f"session-{sid}",
            clock=self.clock,
            queue_budget=self.faults.queue_budget_events,
            shed_policy=self.faults.shed_policy,
        )
        self._by_slot[slot] = sid
        self._health.register(sid)
        return sid

    def feed(self, sid: int, x, y, t, p) -> list[ServedFeed]:
        """Queue one raw event chunk for ``sid``; step the fleet if the
        admission policy fires. Returns the feeds completed by this call
        (every admitted session's, not just ``sid``'s) — ``[]`` while
        the micro-batch is still filling.

        Any feed — including an empty chunk — is a heartbeat. A chunk
        failing validation raises ``ValueError`` under the strict
        default, or quarantines ``sid`` (only) under
        ``on_validation_error="quarantine"``.
        """
        sess = self._live(sid)
        self._health.beat(sid)
        shed_before = sess.stats.shed_events
        try:
            n = sess.accept(x, y, t, p)
        except ValueError as e:
            if self.faults.on_validation_error == "raise":
                raise
            self._quarantine(sess, str(e))
            return []
        if sess.stats.shed_events != shed_before:
            # The budget shed events (possibly previously submitted ones);
            # re-state this session's admitter weight exactly.
            self._admit.restate(sid, sess.queued_events)
        elif n:
            self._admit.submit(sid, weight=n)
        self._sweep_liveness()
        if sess.state == LIVE and self._admit.ready():
            return self.pump()
        return []

    def pump(self, force: bool = False) -> list[ServedFeed]:
        """Run one fleet step over every queued chunk (if admission fired
        or ``force``). Results are delivered per session, slot-ordered.
        Sweeps heartbeat eviction first; a degraded round (step failed
        after retries) returns ``[]`` with every chunk restored.

        With ``max_inflight_rounds > 1`` an admission-triggered round
        that arrives while the pipeline is full (every in-flight slot
        taken, oldest still executing) is deferred: nothing is taken
        from any queue, the admitter keeps its state so the next pump
        retries, and the deferral is accounted per queued session.
        ``force=True`` never defers — it applies backpressure by
        retiring the oldest round instead (drain semantics)."""
        self._sweep_liveness()
        if not force and not self._admit.ready():
            return []
        if not force and not self._dispatch_ready():
            self.deferred_rounds += 1
            for sid in self._by_slot.values():
                sess = self._sessions[sid]
                if sess.queued_events:
                    sess.stats.deferred_rounds += 1
            return []
        self._admit.pop_all()
        dirty = [
            (slot, sid)
            for slot, sid in sorted(self._by_slot.items())
            if self._sessions[sid].queued_events
        ]
        if not dirty:
            return []
        out = self._step({slot: sid for slot, sid in dirty}, final_slots=())
        return [] if out is None else out

    @property
    def inflight_rounds(self) -> int:
        """Dispatched fleet rounds not yet retired (<= max_inflight_rounds)."""
        return len(self._inflight)

    def drain(self) -> None:
        """Retire every in-flight round (block until the device is idle).

        Deferred micro-batches are NOT stepped — call ``pump(force=True)``
        first to flush queues; ``drain`` only empties the pipeline."""
        self._retire(0)

    def detach(self, sid: int) -> ScanResult:
        """Close a session: its queued chunks and trailing partial window
        are processed in one final fleet step (other sessions' queues are
        untouched), the slot carry is zeroed and recycled, and the tail
        result is returned. The session object stays readable for stats.

        If the final step degrades (fails past its retries), the chunks
        are restored and ``RuntimeError`` is raised — the session stays
        live and the detach can be retried."""
        sess = self._live(sid)
        out = self._step({sess.slot: sid}, final_slots=(sess.slot,))
        if out is None:
            raise RuntimeError(
                f"detach of session {sid} degraded (fleet step failed after "
                f"{self.faults.max_step_retries} retries); chunks restored, "
                "retry the detach"
            )
        self._release_slot(sess, DETACHED)
        return out[0].result

    def export_session(self, sid: int) -> SessionExport:
        """Lift a live session out of this service for migration to
        another service (of the same config, on either device).

        The complete state crosses: the fleet slot carry (cursor +
        atlas slice + tracker slice — the entire stream state, so the
        destination resumes bit-identically), the unstepped ingest queue
        with original arrival stamps, the monotone watermark, and the
        accumulated stats/errors. Locally this is a detach-shaped exit
        *without* the flushing step: the slot is zeroed and recycled,
        the admitter entries dropped, and the record retained as
        ``"migrated"``. Works with rounds in flight — the export blocks
        only on the slot's own carry buffers; results already served
        stay valid (outputs are never donated).
        """
        sess = self._live(sid)
        carry = self._fleet.export_slot(sess.slot)
        queue = sess.export_queue()
        self._release_slot(sess, MIGRATED)
        self._maybe_demote()
        export = SessionExport(
            name=sess.name,
            carry=carry,
            queue=queue,
            last_t=sess.last_t,
            stats=sess.stats,
            errors=sess.errors,
        )
        # The live stats/error objects travel WITH the stream; the local
        # migrated record keeps a frozen snapshot (no aliasing with the
        # destination's continued accounting).
        sess.stats = copy.deepcopy(sess.stats)
        sess.errors = list(sess.errors)
        return export

    def adopt_session(self, export: SessionExport, name: str | None = None) -> int:
        """Admit a migrated session: a fresh slot (tier promotion if
        needed, like any attach), the exported carry installed into it,
        and the exported queue/stats/watermark restored. Returns the new
        (local) session id — a caller that moves sessions keeps the global
        identity. The adopted stream is bit-identical to one that never
        migrated, for any interleaving of feeds around the hop."""
        sid = self.attach(name or export.name)
        sess = self._sessions[sid]
        try:
            self._fleet.import_slot(sess.slot, export.carry)
        except (ValueError, IndexError):
            # Shape-incompatible carry (different PipelineConfig): undo
            # the attach so the refusal is atomic on this service.
            self._release_slot(sess, DETACHED)
            del self._sessions[sid]
            raise
        sess.last_t = export.last_t
        sess.stats = export.stats
        sess.errors = export.errors
        for chunk, arrival in export.queue:
            sess.requeue(chunk, arrival)
        if sess.queued_events:
            self._admit.restate(sid, sess.queued_events)
        return sid

    def forget(self, sid: int) -> None:
        """Drop a *closed* (detached / quarantined / evicted) session's
        record. Closed sessions are retained for inspection, not forever
        by obligation — a long-lived churny deployment calls this (or
        periodically sweeps the ``*_sessions`` lists) to bound host
        memory."""
        sess = self._sessions.get(sid)
        if sess is None:
            return
        if sess.state == LIVE:
            raise RuntimeError(f"session {sid} is {sess.state}; detach first")
        del self._sessions[sid]

    # ------------------------------------------------------------------
    # Fault paths.
    # ------------------------------------------------------------------

    def _quarantine(self, sess: SensorSession, message: str) -> None:
        """Validation fault: record, drop the suspect queue + slot
        remainder, recycle the slot. Only this session is touched."""
        err = sess.record_error("validation", message)
        sess.stats.validation_failures += 1
        self.errors.append(err)
        self.quarantines += 1
        sess.drop_queue()
        self._release_slot(sess, QUARANTINED)

    def _sweep_liveness(self) -> None:
        """Evict every live session past its heartbeat deadline: flush
        its queue + trailing window in its own single-slot step, recycle
        the slot, and demote the pool tier if the tail emptied."""
        for sid in self._health.expired():
            self._evict(sid)

    def _evict(self, sid: int) -> None:
        sess = self._sessions[sid]
        out = self._step({sess.slot: sid}, final_slots=(sess.slot,))
        if out is None:
            return  # flush degraded; chunks restored, retry next sweep
        err = sess.record_error(
            "evicted",
            f"no heartbeat for > {self.faults.heartbeat_timeout_s} s; "
            "slot flushed and recycled",
        )
        self.errors.append(err)
        self.evictions += 1
        sess.tail_result = out[0].result
        self._release_slot(sess, EVICTED)
        self._maybe_demote()

    def _release_slot(self, sess: SensorSession, state: str) -> None:
        """Common slot-recycle path for every exit (detach / quarantine /
        evict): admitter purged by the caller, carry zeroed, slot freed."""
        self._health.forget(sess.sid)
        self._admit.discard(sess.sid)
        del self._by_slot[sess.slot]
        bisect.insort(self._free, sess.slot)
        self._fleet.reset_slots([sess.slot])
        sess.state = state
        sess.slot = -1

    def _maybe_demote(self) -> None:
        """Shrink the pool back a tier when the tail slots all freed up
        (carry sliced; surviving slots keep their state verbatim)."""
        if not self.faults.demote_tiers:
            return
        while True:
            cap = self.capacity
            if cap > self.tiers[-1]:
                lower = cap // 2  # doubling schedule past the last tier
            else:
                lower = max((t for t in self.tiers if t < cap), default=None)
            if lower is None or (self._by_slot and max(self._by_slot) >= lower):
                return
            self._fleet.shrink(lower, occupied=list(self._by_slot))
            self._free = [s for s in self._free if s < lower]
            self.demotions += 1

    # ------------------------------------------------------------------
    # Internals.
    # ------------------------------------------------------------------

    def _live(self, sid: int) -> SensorSession:
        sess = self._sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown session id {sid}")
        if sess.state != LIVE:
            raise RuntimeError(f"session {sid} is {sess.state}")
        return sess

    def _dispatch_ready(self) -> bool:
        """Can a new round be dispatched without blocking on the device?"""
        return (
            len(self._inflight) < self.max_inflight_rounds
            or self._inflight[0].ready()
        )

    def _retire(self, keep: int) -> None:
        """Await the oldest in-flight rounds until at most ``keep`` remain."""
        while len(self._inflight) > keep:
            self._inflight.pop(0).wait()

    def _step(
        self, by_slot: dict[int, int], final_slots: tuple[int, ...]
    ) -> list[ServedFeed] | None:
        """One fleet step over the named slots' merged queues, dispatched
        asynchronously into the in-flight window.

        A dispatch that raises is retried up to ``max_step_retries``
        times with exponential backoff (the fleet validates before
        mutating — phase A — so a failed dispatch leaves the carry
        untouched and the same chunks re-feed exactly; this is the
        boundary where chunk-induced faults surface even with rounds
        already in flight, since earlier rounds' outputs are never
        donated). When retries are exhausted: with
        ``degrade_on_step_failure`` every taken chunk is restored to its
        session queue (original arrival stamps — nothing lost, latency
        clocks intact), the round is recorded degraded, and ``None`` is
        returned; otherwise the last error propagates (strict default).

        Before dispatching, the oldest in-flight rounds are retired down
        to ``max_inflight_rounds - 1`` (backpressure); at depth 1 the
        new round is also awaited before returning — the synchronous
        path. Per-session accounting (steps, windows, latency, health)
        happens at dispatch from host-side window counts, so counters
        are exact regardless of when results are consumed.
        """
        chunks: list = [None] * self.capacity
        arrivals: dict[int, float | None] = {}
        for slot, sid in by_slot.items():
            chunks[slot], arrivals[sid] = self._sessions[sid].take()
        final = np.zeros(self.capacity, bool)
        if final_slots:
            final[list(final_slots)] = True
        self._retire(self.max_inflight_rounds - 1)
        pending = None
        for attempt in range(self.faults.max_step_retries + 1):
            try:
                pending = self._fleet.feed_async(chunks, final=final)
                break
            except Exception as e:  # noqa: BLE001 — device-step failure
                last_err = e
                if attempt == self.faults.max_step_retries:
                    if not self.faults.degrade_on_step_failure:
                        raise
                    break
                self.step_retries += 1
                backoff = self.faults.retry_backoff_s * (2**attempt)
                if backoff:
                    self._sleep(backoff)
        if pending is None:
            self.degraded_rounds += 1
            for slot, sid in by_slot.items():
                sess = self._sessions[sid]
                if chunks[slot] is not None:
                    sess.restore(chunks[slot], arrivals[sid])
                    self._admit.restate(sid, sess.queued_events)
                sess.stats.degraded_rounds += 1
                self.errors.append(
                    sess.record_error(
                        "degraded_round",
                        f"fleet step failed after {self.faults.max_step_retries}"
                        f" retries ({type(last_err).__name__}: {last_err}); "
                        "chunks restored",
                    )
                )
            return None
        self._inflight.append(pending)
        self.last_round = pending
        now = self.clock()
        served: list[ServedFeed] = []
        for slot in sorted(by_slot):
            sid = by_slot[slot]
            sess = self._sessions[sid]
            arrival = arrivals[sid]
            latency_ms = None if arrival is None else (now - arrival) * 1e3
            sess.record_step(int(pending.n_windows[slot]), latency_ms)
            if latency_ms is not None:
                self._health.note_latency(sid, latency_ms)
            served.append(
                ServedFeed(
                    sid=sid, latency_ms=latency_ms or 0.0,
                    _round=pending, _slot=slot,
                )
            )
        if self.max_inflight_rounds == 1:
            self._retire(0)  # synchronous path: round awaited before return
        return served
