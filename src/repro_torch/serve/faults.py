"""Fault-tolerance policy for the detection service: the port of
``repro.serve.faults``.

:class:`FaultConfig` is the one knob block: what happens on a
validation failure (raise, the strict default, or quarantine the
offending session), how big a session's ingest queue may grow and which
shed policy bounds it, how long a silent sensor lives before heartbeat
eviction, and how many times a failed fleet step retries before the
round is marked degraded.

:class:`SessionHealth` adapts the generic cluster-liveness primitives —
:class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor` and
:class:`~repro_torch.distributed.fault_tolerance.StragglerTracker` — to
sensor sessions: node ids are session ids,
a heartbeat is any ``feed`` call (an empty chunk counts — that is what
a live but quiet sensor sends), and the straggler EMA runs over
per-session service latencies so persistently slow feeds are flagged
relative to the fleet median. Everything is clock-injected; nothing
here sleeps or threads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.distributed.fault_tolerance import HeartbeatMonitor, StragglerTracker
from repro_torch.serve.sessions import SHED_POLICIES, SHED_REJECT

ON_VALIDATION = ("raise", "quarantine")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault handling policy for :class:`~repro_torch.serve.service.DetectionService`.

    The default is the strict contract — validation errors raise at
    the ``feed`` call, queues are unbounded, nothing is evicted and a
    step failure propagates. A fault-tolerant deployment turns each
    degraded-mode behaviour on explicitly; the bit-identity guarantee
    (healthy sessions' outputs never change, faults on or off) holds for
    every combination.
    """

    # Accept-time validation failure: "raise" (strict, default) or
    # "quarantine" (record the error, recycle the slot, keep serving).
    on_validation_error: str = "raise"
    # Per-session ingest bound: max queued events (None = unbounded) and
    # the shed policy applied when a chunk would exceed it.
    queue_budget_events: int | None = None
    shed_policy: str = SHED_REJECT
    # A live session whose last feed (any feed — empty chunks are
    # heartbeats) is older than this is evicted: flushed, slot recycled.
    # None disables eviction.
    heartbeat_timeout_s: float | None = None
    # Capacity-tier demotion after evictions empty the pool's tail.
    demote_tiers: bool = True
    # Straggler flagging: per-session service-latency EMA more than
    # `straggler_factor` x the fleet median marks the session slow.
    straggler_factor: float = 4.0
    straggler_alpha: float = 0.2
    # A fleet step that raises is retried with exponential backoff
    # (base * 2^attempt). With `degrade_on_step_failure`, exhausting the
    # retries marks the round degraded — every taken chunk is restored
    # to its session queue and the service returns [] instead of
    # raising; the strict default propagates the last error.
    max_step_retries: int = 2
    retry_backoff_s: float = 0.0
    degrade_on_step_failure: bool = False

    def __post_init__(self):
        if self.on_validation_error not in ON_VALIDATION:
            raise ValueError(
                f"on_validation_error must be one of {ON_VALIDATION}, "
                f"got {self.on_validation_error!r}"
            )
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, "
                f"got {self.shed_policy!r}"
            )
        if self.queue_budget_events is not None and self.queue_budget_events < 1:
            raise ValueError(
                f"queue_budget_events must be >= 1, got {self.queue_budget_events}"
            )
        if self.heartbeat_timeout_s is not None and self.heartbeat_timeout_s <= 0:
            raise ValueError(
                f"heartbeat_timeout_s must be > 0, got {self.heartbeat_timeout_s}"
            )
        if self.max_step_retries < 0:
            raise ValueError(
                f"max_step_retries must be >= 0, got {self.max_step_retries}"
            )
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}"
            )
        if self.straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {self.straggler_factor}"
            )


class SessionHealth:
    """Liveness + slowness tracking for live sessions, keyed by sid."""

    def __init__(self, config: FaultConfig, clock: Callable[[], float]):
        self.config = config
        self._monitor = (
            None
            if config.heartbeat_timeout_s is None
            else HeartbeatMonitor(
                timeout_s=config.heartbeat_timeout_s, clock=clock
            )
        )
        self._straggler = StragglerTracker(
            factor=config.straggler_factor, alpha=config.straggler_alpha
        )

    def register(self, sid: int) -> None:
        if self._monitor is not None:
            self._monitor.register(sid)

    def forget(self, sid: int) -> None:
        if self._monitor is not None and sid in self._monitor:
            self._monitor.forget(sid)
        self._straggler.forget(sid)

    def beat(self, sid: int) -> None:
        if self._monitor is not None:
            self._monitor.beat(sid)

    def expired(self) -> list[int]:
        """Live sids whose heartbeat deadline has passed (eviction set)."""
        if self._monitor is None:
            return []
        return self._monitor.failed_nodes()

    def note_latency(self, sid: int, latency_ms: float) -> None:
        self._straggler.record(sid, latency_ms)

    def stragglers(self) -> list[int]:
        """Sids whose service-latency EMA exceeds ``straggler_factor`` x
        the fleet median — persistently slow feeds, flagged not evicted."""
        return self._straggler.stragglers()
