"""Liveness and straggler tracking: the port of the part of
``repro.distributed.fault_tolerance`` that serving uses.

* :class:`HeartbeatMonitor` tracks per-node liveness over an explicit
  roster; a node silent for more than ``timeout_s`` is declared failed.
  The clock is injected, so tests simulate failures deterministically.
* :class:`StragglerTracker` keeps an EMA of per-node step times with an
  outlier rule (EMA > factor x the fleet median = straggler).

Both are pure Python. The detection service keys them by session id
(:mod:`repro_torch.serve.faults`). The checkpoint/restart loop
(``FailureEvent``, ``ElasticRunner``) drives training and waits for the
train stack.
"""
from __future__ import annotations

import time
from typing import Any


class HeartbeatMonitor:
    """Per-node liveness with an explicit membership roster.

    Membership is explicit — :meth:`register` / :meth:`forget` — and
    :meth:`beat` raises ``KeyError`` for an unregistered id: a typo'd
    node (or sensor) id must surface as an error, not silently create a
    phantom healthy node that the failure detector then vouches for.
    Node ids are any hashable (host names for training jobs, session
    ids for the detection service).
    """

    def __init__(self, node_ids=(), timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last: dict[Any, float] = {n: now for n in node_ids}

    def __contains__(self, node_id) -> bool:
        return node_id in self._last

    @property
    def nodes(self) -> list:
        """Registered node ids, registration-ordered."""
        return list(self._last)

    def register(self, node_id) -> None:
        """Add a node, its heartbeat stamped now. Re-registering a live
        id raises — two owners of one id is a bookkeeping bug."""
        if node_id in self._last:
            raise ValueError(f"node {node_id!r} is already registered")
        self._last[node_id] = self._clock()

    def forget(self, node_id) -> None:
        """Remove a node from the roster (``KeyError`` if unknown), so a
        departed node stops counting as failed forever."""
        del self._last[node_id]

    def beat(self, node_id) -> None:
        if node_id not in self._last:
            raise KeyError(
                f"heartbeat from unregistered node {node_id!r}; register() it"
            )
        self._last[node_id] = self._clock()

    def last_beat_s(self, node_id) -> float:
        """Clock time of the node's most recent beat (KeyError if unknown)."""
        return self._last[node_id]

    def failed_nodes(self) -> list:
        now = self._clock()
        return [n for n, t in self._last.items() if now - t > self.timeout_s]

    def healthy_nodes(self) -> list:
        now = self._clock()
        return [n for n, t in self._last.items() if now - t <= self.timeout_s]


class StragglerTracker:
    """EMA-based straggler detection over per-node step times."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self._ema: dict[Any, float] = {}

    def record(self, node_id, step_time_s: float) -> None:
        prev = self._ema.get(node_id, step_time_s)
        self._ema[node_id] = (1 - self.alpha) * prev + self.alpha * step_time_s

    def forget(self, node_id) -> None:
        """Drop a node's EMA (no-op if never recorded) so departed nodes
        stop weighing on the fleet median."""
        self._ema.pop(node_id, None)

    def ema(self, node_id) -> float | None:
        return self._ema.get(node_id)

    def fleet_median(self) -> float:
        """True median of the per-node EMAs: for an even count the mean
        of the two middle elements (the upper-middle element alone biases
        high, inflating the straggler threshold)."""
        if not self._ema:
            return 0.0
        vals = sorted(self._ema.values())
        n = len(vals)
        mid = vals[n // 2]
        if n % 2 == 0:
            mid = (vals[n // 2 - 1] + mid) / 2.0
        return mid

    def stragglers(self) -> list:
        med = self.fleet_median()
        if med == 0.0:
            return []
        return [n for n, t in self._ema.items() if t > self.factor * med]
