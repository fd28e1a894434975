"""Dual-threshold admission policy as a generic, workload-agnostic
primitive: the port of ``repro.serve.batcher``.

The paper's client buffers camera events and closes a batch when EITHER
20,000 us elapse OR 250 events accumulate (Sec. III-A), bounding both
latency (time cut) and work granularity (size cut). The detection
service (:mod:`repro_torch.serve.service`) admits a fleet step by the
same rule: when the oldest queued sensor chunk is ``max_delay_s`` old or
``max_items`` events are queued fleet-wide.

:class:`DualThresholdAdmitter` holds no threads and never sleeps: callers
inject ``clock`` (any ``() -> float`` in seconds, ``time.monotonic`` by
default), poll :meth:`DualThresholdAdmitter.ready`, and drain with
:meth:`DualThresholdAdmitter.pop`, so the policy is exactly testable with
a fake clock and composes with any event loop.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Dual-threshold close rule: oldest item age OR total queued weight.

    ``max_items`` counts *weight*, not entries: each submit carries a
    weight (1 by default), so "250 events" is detection chunks weighted
    by their event counts.
    """

    max_delay_s: float = 0.020  # paper: 20 ms window
    max_items: int = 250  # paper: 250 events

    def __post_init__(self):
        if self.max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {self.max_delay_s}")
        if self.max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {self.max_items}")


@dataclasses.dataclass
class _Entry(Generic[T]):
    arrival_s: float
    item: T
    weight: int


class DualThresholdAdmitter(Generic[T]):
    """Close a batch at ``max_delay_s`` OR ``max_items`` — whichever first.

    >>> clock = lambda: now[0]
    >>> adm = DualThresholdAdmitter(AdmissionConfig(0.02, 4), clock)
    >>> adm.submit("a"); adm.ready()
    False
    >>> now[0] += 0.025; adm.ready()
    True
    >>> adm.pop()
    ['a']
    """

    def __init__(
        self,
        config: AdmissionConfig = AdmissionConfig(),
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config
        self.clock = clock
        self._queue: list[_Entry[T]] = []
        self._weight = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending_weight(self) -> int:
        return self._weight

    @property
    def items(self) -> list[T]:
        """Queued items in arrival order (read-only view)."""
        return [e.item for e in self._queue]

    def oldest_age_s(self) -> float:
        """Seconds since the oldest queued item arrived (0 when empty)."""
        if not self._queue:
            return 0.0
        return self.clock() - self._queue[0].arrival_s

    def submit(self, item: T, weight: int = 1) -> None:
        """Queue an item, stamped with the injected clock's now."""
        if weight < 0:
            raise ValueError(f"weight must be >= 0, got {weight}")
        self._queue.append(_Entry(self.clock(), item, weight))
        self._weight += weight

    def discard(self, item: T) -> int:
        """Drop every queued entry equal to ``item`` (returns the count).

        For producers that leave the queue out of band — e.g. a detached
        detection session whose chunks were consumed by its final step:
        its stale entries must not keep aging (or weighing) toward the
        next admission, which would fire the time cut spuriously for
        everyone else.
        """
        keep = [e for e in self._queue if e.item != item]
        dropped = len(self._queue) - len(keep)
        if dropped:
            self._weight -= sum(
                e.weight for e in self._queue if e.item == item
            )
            self._queue = keep
        return dropped

    def restate(self, item: T, weight: int) -> None:
        """Replace every queued entry for ``item`` with ONE entry of the
        given weight, keeping the oldest of their arrival stamps.

        For producers whose queued weight changed out of band — e.g. a
        detection session whose queue budget shed events: the stale
        entries would keep firing the size threshold for weight that no
        longer exists. ``weight == 0`` just clears the item's entries
        (:meth:`discard`); with no prior entries the new one is stamped
        now. The replacement entry is inserted in arrival order, so the
        prefix-pop rule and ``oldest_age_s`` stay exact.
        """
        if weight < 0:
            raise ValueError(f"weight must be >= 0, got {weight}")
        arrivals = [e.arrival_s for e in self._queue if e.item == item]
        self.discard(item)
        if weight == 0:
            return
        arrival = min(arrivals) if arrivals else self.clock()
        entry = _Entry(arrival, item, weight)
        ix = bisect.bisect_right(
            [e.arrival_s for e in self._queue], arrival
        )
        self._queue.insert(ix, entry)
        self._weight += weight

    def ready(self) -> bool:
        if not self._queue:
            return False
        if self._weight >= self.config.max_items:
            return True
        return self.oldest_age_s() >= self.config.max_delay_s

    def pop(self) -> list[T]:
        """Drain one admitted batch: the longest arrival-order prefix whose
        cumulative weight fits ``max_items`` (always at least one item, so
        an over-weight head entry cannot wedge the queue)."""
        out: list[T] = []
        acc = 0
        while self._queue:
            head = self._queue[0]
            if out and acc + head.weight > self.config.max_items:
                break
            out.append(head.item)
            acc += head.weight
            self._weight -= head.weight
            self._queue.pop(0)
        return out

    def pop_all(self) -> list[T]:
        """Drain the whole queue regardless of weight (micro-batch
        consumers that can absorb arbitrarily many items per step)."""
        out = [e.item for e in self._queue]
        self._queue.clear()
        self._weight = 0
        return out


def drain(admitter: DualThresholdAdmitter[Any], force: bool = False) -> list[Any]:
    """``pop_all`` if the admitter is ready (or ``force``), else ``[]``."""
    if force or admitter.ready():
        return admitter.pop_all()
    return []
