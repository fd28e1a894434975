"""Per-sensor session lifecycle for the detection service: the port of
``repro.serve.sessions``.

A :class:`SensorSession` is the service-side identity of one live event
camera: it owns the sensor's slot in the fleet pool, validates the
monotone-timestamp contract at *accept* time (a bad chunk is refused
before it is ever queued, so the micro-batch a session rides in can
never be poisoned by it), buffers accepted chunks until the admission
policy releases a fleet step — under an optional queue budget with
exact shed accounting — and keeps the per-session accounting the
operator reads: feeds, events, windows, backlog, shed counts, and
service-latency samples.

Sessions are plain host objects — all device state lives in the fleet
carry, keyed by ``slot``. The lifecycle is::

    attach (service assigns a zeroed slot)
      -> feed* (validate -> queue -> fleet step on admission)
      -> detach (flush trailing window, slot zeroed + recycled)

after which the session object survives as a read-only stats record
(``state == "detached"``). Two fault exits leave the same read-only
record: ``"quarantined"`` (an accept-time
validation failure under ``on_validation_error="quarantine"`` — queued
chunks and the slot remainder are discarded, the slot recycled) and
``"evicted"`` (heartbeat deadline missed — queued chunks and the
trailing window are flushed into ``tail_result``, then the slot is
recycled). Every fault transition appends a structured
:class:`SessionError` to ``errors``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.events import validate_monotone

Chunk = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

LIVE = "live"
DETACHED = "detached"
QUARANTINED = "quarantined"
EVICTED = "evicted"
# Exported to another service (session migration): the local record
# survives read-only, like a detach, but the stream itself continues
# bit-identically under a new sid on the adopting service.
MIGRATED = "migrated"

# Shed policies for a budget-bounded session queue.
SHED_REJECT = "reject"          # refuse the whole over-budget chunk
SHED_DROP_OLDEST = "drop_oldest"  # admit the new chunk, drop oldest queued
SHED_POLICIES = (SHED_REJECT, SHED_DROP_OLDEST)


# Latency samples retained per session (a sliding window, so a long-lived
# session's stats stay O(1) in memory; counters stay exact forever).
MAX_LATENCY_SAMPLES = 1024


@dataclasses.dataclass(frozen=True)
class SessionError:
    """One structured fault record on a session (or service) timeline.

    ``kind`` is one of ``"validation"`` (bad chunk refused at accept),
    ``"evicted"`` (heartbeat deadline missed), ``"degraded_round"``
    (a fleet step exhausted its retries; the round's chunks were
    restored, nothing was lost).
    """

    kind: str
    sid: int
    time_s: float  # service clock at the fault
    message: str


@dataclasses.dataclass
class SessionStats:
    """Monotone per-session counters plus service-latency samples.

    ``latency_ms`` keeps only the most recent :data:`MAX_LATENCY_SAMPLES`
    samples — percentiles describe recent behaviour, and a session
    feeding at live cadence for days cannot grow host memory unboundedly.

    Shed accounting is exact by construction: every event offered to
    :meth:`SensorSession.accept` on a live session is either accepted
    or shed, so ``offered_events == events + shed_events`` always
    (validation-refused chunks are counted in neither — they were never
    admitted into the accounting stream; they increment
    ``validation_failures`` instead).
    """

    feeds: int = 0  # chunks accepted (empty chunks are no-ops, not counted)
    events: int = 0  # events accepted
    offered_events: int = 0  # events offered past validation (accepted + shed)
    shed_events: int = 0  # events shed by the queue budget
    shed_chunks: int = 0  # whole chunks shed (reject) or dropped (drop_oldest)
    validation_failures: int = 0  # chunks refused by validate/range checks
    degraded_rounds: int = 0  # fleet rounds that failed + restored this queue
    # Admission rounds deferred while this session had queued data because
    # the ingest pipeline was full (max_inflight_rounds reached, oldest
    # round still executing). Deferral is backpressure, not loss: the
    # queue and the admitter state are untouched, so the events ride the
    # next dispatched round and offered == events + shed stays exact.
    deferred_rounds: int = 0
    steps: int = 0  # fleet steps this session's chunks rode in
    windows: int = 0  # windows closed and returned to the session
    latency_ms: list[float] = dataclasses.field(default_factory=list)

    def record_latency(self, latency_ms: float) -> None:
        self.latency_ms.append(latency_ms)
        if len(self.latency_ms) > MAX_LATENCY_SAMPLES:
            del self.latency_ms[: len(self.latency_ms) - MAX_LATENCY_SAMPLES]

    def latency_percentile(self, q: float) -> float:
        """q-th percentile of the retained latency samples (0 when none)."""
        if not self.latency_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latency_ms), q))


@dataclasses.dataclass
class _Queued:
    """One accepted-but-unstepped chunk with its arrival stamp."""

    chunk: Chunk
    n: int
    arrival_s: float


# Coordinate sanity bound: anything outside this range cannot be a pixel
# address on any supported sensor and would wrap when packed into the
# int32 transfer planes — treat it as corruption, not as an off-sensor
# event (which the pipeline masks fine). Polarity gets the same net.
COORD_LIMIT = 1 << 30


@dataclasses.dataclass
class SensorSession:
    """One attached sensor: slot ownership, validation, bounded chunk
    queue, shed accounting, stats."""

    sid: int
    slot: int
    name: str
    clock: Callable[[], float]
    state: str = LIVE
    queue_budget: int | None = None  # max queued events (None = unbounded)
    shed_policy: str = SHED_REJECT
    last_t: int | None = None  # newest accepted timestamp
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)
    errors: list[SessionError] = dataclasses.field(default_factory=list)
    tail_result: object | None = None  # eviction flush tail (ScanResult)
    # Chunks accepted but not yet absorbed by a fleet step, each with its
    # arrival stamp (service-latency measurement origin; the oldest
    # surviving stamp rides through drop_oldest shedding exactly).
    _queue: list[_Queued] = dataclasses.field(default_factory=list)
    _queued_events: int = 0

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, "
                f"got {self.shed_policy!r}"
            )
        if self.queue_budget is not None and self.queue_budget < 1:
            raise ValueError(
                f"queue_budget must be >= 1 events, got {self.queue_budget}"
            )

    @property
    def queued_events(self) -> int:
        """Events accepted but not yet handed to the fleet step."""
        return self._queued_events

    def accept(self, x, y, t, p) -> int:
        """Validate and queue one raw chunk; returns the number of its
        events actually queued (less than ``len(t)`` when the queue
        budget shed).

        Raises ``ValueError`` (chunk not absorbed, session unharmed) when
        the chunk is out of order within itself or against this session's
        stream — the same contract :class:`StreamingPipeline` enforces —
        or when coordinates/polarities are corrupt (outside
        ``±COORD_LIMIT``: garbage that would wrap in the int32 transfer
        planes, as opposed to merely off-sensor events, which the
        pipeline masks). The error surfaces at the offending ``feed``
        call rather than inside a later micro-batched fleet step.
        """
        if self.state != LIVE:
            raise RuntimeError(f"session {self.sid} is {self.state}")
        t = np.asarray(t, np.int64)
        validate_monotone(t, self.last_t, label=f"session {self.sid}")
        x, y, p = (np.asarray(a, np.int64) for a in (x, y, p))
        for label, a in (("x", x), ("y", y), ("p", p)):
            if len(a) and (
                int(a.min()) <= -COORD_LIMIT or int(a.max()) >= COORD_LIMIT
            ):
                raise ValueError(
                    f"session {self.sid}: corrupt {label} values outside "
                    f"+-{COORD_LIMIT} (int32-unsafe garbage, not off-sensor "
                    "coordinates)"
                )
        n = len(t)
        if n == 0:
            return 0  # heartbeat: nothing to queue
        self.stats.offered_events += n
        budget = self.queue_budget
        if budget is not None and self._queued_events + n > budget:
            accepted = self._shed(x, y, t, p, n, budget)
        else:
            self._push((x, y, t, p), n)
            accepted = n
        # Exact accounting invariant: offered == accepted(events) + shed.
        self.last_t = int(t[-1])
        return accepted

    def _push(self, chunk: Chunk, n: int) -> None:
        self._queue.append(_Queued(chunk, n, self.clock()))
        self._queued_events += n
        self.stats.feeds += 1
        self.stats.events += n

    def _shed(self, x, y, t, p, n: int, budget: int) -> int:
        """Apply the shed policy to an over-budget chunk; returns the
        number of the chunk's events queued."""
        if self.shed_policy == SHED_REJECT:
            # Refuse the whole chunk; queued data is older and keeps its
            # service-latency clock. The stream simply has a gap (the
            # pipeline is gap-tolerant; last_t still advances so later
            # chunks validate against the true newest timestamp).
            self.stats.shed_events += n
            self.stats.shed_chunks += 1
            return 0
        # drop_oldest: the freshest data wins. Shed the oldest queued
        # chunks until the new one fits; an oversized chunk keeps only
        # its newest `budget` events (a prefix drop preserves the
        # time-sorted contract).
        keep_n = min(n, budget)
        if keep_n < n:
            cut = n - keep_n
            x, y, t, p = x[cut:], y[cut:], t[cut:], p[cut:]
            self.stats.shed_events += cut
        while self._queue and self._queued_events + keep_n > budget:
            old = self._queue.pop(0)
            self._queued_events -= old.n
            self.stats.shed_events += old.n
            self.stats.shed_chunks += 1
            # The shed chunk was counted accepted at its own accept();
            # un-count it so `events` tracks what the fleet will see.
            self.stats.events -= old.n
            self.stats.feeds -= 1
        self._push((x, y, t, p), keep_n)
        return keep_n

    def take(self) -> tuple[Chunk | None, float | None]:
        """Drain the queue as one merged chunk for a fleet step.

        Returns ``(chunk, oldest_arrival_s)`` — ``(None, None)`` when
        nothing is queued. Merging is safe: chunks were validated in
        accept order, and the streaming engine is bit-identical under
        any re-chunking, so one merged feed returns exactly the windows
        the individual feeds would have.
        """
        if not self._queue:
            return None, None
        if len(self._queue) == 1:
            chunk = self._queue[0].chunk
        else:
            chunk = tuple(
                np.concatenate([q.chunk[i] for q in self._queue])
                for i in range(4)
            )
        arrival = self._queue[0].arrival_s
        self._queue.clear()
        self._queued_events = 0
        return chunk, arrival

    def restore(self, chunk: Chunk, arrival_s: float | None) -> None:
        """Put back a chunk handed out by :meth:`take` after a fleet step
        failed (degraded round): the data re-queues at the head with its
        original arrival stamp, so nothing is lost and the latency clock
        keeps measuring from the true oldest arrival."""
        n = len(chunk[2])
        self._queue.insert(
            0, _Queued(chunk, n, self.clock() if arrival_s is None else arrival_s)
        )
        self._queued_events += n

    def export_queue(self) -> list[tuple[Chunk, float]]:
        """Drain the queue as ``(chunk, arrival_s)`` pairs in arrival
        order — the migration counterpart of :meth:`take`. Unlike
        ``take`` the chunks stay separate with their own stamps, so the
        adopting session (:meth:`requeue`) reconstructs the queue
        exactly: latency clocks and shed bookkeeping carry over."""
        out = [(q.chunk, q.arrival_s) for q in self._queue]
        self._queue.clear()
        self._queued_events = 0
        return out

    def requeue(self, chunk: Chunk, arrival_s: float) -> None:
        """Append one exported chunk with its original arrival stamp
        (adopt path). No stats are touched: the exported
        :class:`SessionStats` already counted these events at their
        original ``accept``."""
        self._queue.append(_Queued(chunk, len(chunk[2]), arrival_s))
        self._queued_events += len(chunk[2])

    def drop_queue(self) -> int:
        """Discard every queued chunk (quarantine path); returns the
        number of events discarded."""
        dropped = self._queued_events
        self._queue.clear()
        self._queued_events = 0
        return dropped

    def record_step(self, n_windows: int, latency_ms: float | None) -> None:
        """Account one fleet step; ``latency_ms`` is None when the step
        carried no queued chunk for this session (a bare detach flush),
        which is not a service-latency sample."""
        self.stats.steps += 1
        self.stats.windows += n_windows
        if latency_ms is not None:
            self.stats.record_latency(latency_ms)

    def record_error(self, kind: str, message: str) -> SessionError:
        err = SessionError(
            kind=kind, sid=self.sid, time_s=self.clock(), message=message
        )
        self.errors.append(err)
        return err
