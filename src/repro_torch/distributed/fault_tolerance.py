"""Liveness, straggler tracking and the checkpoint/restart loop: the
port of ``repro.distributed.fault_tolerance``.

* :class:`HeartbeatMonitor` tracks per-node liveness over an explicit
  roster; a node silent for more than ``timeout_s`` is declared failed.
  The clock is injected, so tests simulate failures deterministically.
* :class:`StragglerTracker` keeps an EMA of per-node step times with an
  outlier rule (EMA > factor x the fleet median = straggler).
* :class:`ElasticRunner` — the restart loop: run steps, checkpoint every
  ``ckpt_every``, and on failure rebuild the "mesh" and restore the
  latest checkpoint. On one card the mesh is whatever ``mesh_factory``
  returns (the reference rebuilds a device mesh from the survivors).

All pure Python. The detection service keys the first two by session id
(:mod:`repro_torch.serve.faults`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable


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


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str  # "node_lost" | "preemption" | "nan_loss"
    detail: str = ""


class ElasticRunner:
    """Checkpoint/restart training loop.

    ``make_state(mesh)`` builds (or restores) train state for a mesh;
    ``step_fn(state, batch) -> state, metrics`` runs one step;
    ``mesh_factory(n_failures)`` returns the (possibly shrunken) mesh
    after each failure. Failures are raised by ``failure_hook`` (tests) or
    detected via non-finite loss. ``ckpt`` is a
    :class:`~repro_torch.train.checkpoint.CheckpointManager`; the state
    is a tree it can save and restore into.
    """

    def __init__(
        self,
        mesh_factory: Callable[[int], Any],
        make_state: Callable[[Any], Any],
        step_fn: Callable[[Any, Any], tuple[Any, dict]],
        ckpt,
        ckpt_every: int = 10,
        failure_hook: Callable[[int], FailureEvent | None] | None = None,
    ):
        self.mesh_factory = mesh_factory
        self.make_state = make_state
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.failure_hook = failure_hook
        self.events: list[FailureEvent] = []
        self.restarts = 0

    def run(self, batches: list[Any], start_step: int = 0) -> tuple[Any, list[dict]]:
        mesh = self.mesh_factory(self.restarts)
        state = self.make_state(mesh)
        latest = self.ckpt.latest_step()
        step = start_step
        if latest is not None:
            step, state = self.ckpt.restore(state)
            step += 1
        metrics_log: list[dict] = []
        i = step
        while i < len(batches):
            if self.failure_hook is not None:
                ev = self.failure_hook(i)
                if ev is not None:
                    # Simulated node loss: rebuild mesh, restore, resume.
                    self.events.append(ev)
                    self.restarts += 1
                    mesh = self.mesh_factory(self.restarts)
                    state = self.make_state(mesh)
                    latest = self.ckpt.latest_step()
                    if latest is not None:
                        resume, state = self.ckpt.restore(state)
                        i = resume + 1
                    else:
                        i = 0
                    continue
            state, metrics = self.step_fn(state, batches[i])
            loss = float(metrics.get("loss", 0.0))
            if loss != loss:  # NaN — restore from last good checkpoint
                self.events.append(FailureEvent(i, "nan_loss"))
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise RuntimeError("NaN loss before first checkpoint")
                resume, state = self.ckpt.restore(state)
                i = resume + 1
                continue
            metrics_log.append(dict(metrics, step=i))
            if i % self.ckpt_every == 0:
                self.ckpt.save_async(i, state)
            i += 1
        self.ckpt.wait()
        return state, metrics_log
