"""The fleet: live sensors feeding one card, a 20 ms chunk a sensor a round.

Each sensor replays its lap of generated sky endlessly, lap ``k`` shifted
by ``k`` laps' length, so every stream stays time-sorted. A round hands
every sensor's next chunk to ``FleetPipeline.feed_async``; ``in_flight``
rounds are kept in flight, so round ``k`` completes after round ``k + 1``
is submitted: its ``PendingRound.result()`` and the host view of every
sensor (``results()``). A round's latency runs from its ``feed_async``
call to its host views.

The answers compared are a sample of the window's rounds, one in
``sample_every`` drawn from the seed, and the last round: each sensor's
windows, clusters, metrics and tracker states. A sampled round's host
views are only kept as it completes; they are flattened into arrays once
the window has closed. Every round's count of closed windows a sensor is
compared as well.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from harness import traffic as T
from harness.bench import Unit
from harness.compare import Answers
from harness.reference import CLUSTER_FIELDS, METRICS, TRACK_FIELDS
from harness.trace import UNIT_SPAN


class Session:
    final = False  # a live stream's trailing window stays open

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.device = config, traffic, device
        self.n_sensors = config["fleet"]["n_sensors"]
        self.laps = T.laps(traffic, self.n_sensors, seed)
        self._rng = np.random.default_rng(np.random.SeedSequence([T.entropy(seed), 1]))
        self._round = 0  # rounds fed so far, warm-up included
        self._counts: list[np.ndarray] = []  # each round's closed windows a sensor
        self._closed = np.zeros(self.n_sensors, np.int64)  # windows a sensor so far
        self._pending: deque = deque()
        self.done: list[Unit] = []
        self._kept: list[tuple] = []  # the sampled rounds' (counts, first, views)
        self._last: tuple | None = None  # the latest round, until the next
        self._sampling = False

    def setup(self) -> None:
        from repro_torch.core.pipeline import FleetPipeline, config_from_dict

        self.cfg = config_from_dict(self.config["pipeline"])
        f = self.config["fleet"]
        self.fp = FleetPipeline(self.cfg, n_sensors=self.n_sensors, wire=f["wire"],
                                staging_depth=f["staging_depth"], device=self.device)
        for _ in range(self.traffic["warmup_rounds"]):
            self.step()
        self.drain()
        self._sampling = True

    def step(self) -> None:
        """Submit the next round, completing the oldest once ``in_flight``
        are out."""
        from torch.profiler import record_function

        k = self._round
        chunks = [T.lap_chunk(lap, k) for lap in self.laps]
        events = sum(len(c[2]) for c in chunks)
        t0 = time.perf_counter()
        with record_function(UNIT_SPAN):
            pending = self.fp.feed_async(chunks)
        self._pending.append((t0, time.perf_counter() - t0, events, pending))
        self._round += 1
        if len(self._pending) >= self.traffic["in_flight"]:
            self._complete()

    def drain(self) -> None:
        while self._pending:
            self._complete()

    def _complete(self) -> None:
        from torch.profiler import record_function

        t0, submit_s, events, pending = self._pending.popleft()
        with record_function(UNIT_SPAN):
            views = pending.result().results()
        seconds = time.perf_counter() - t0
        counts = np.asarray(pending.n_windows, np.int64)
        first = self._closed.copy()
        self._closed += counts
        self._counts.append(counts)
        busy = np.flatnonzero(counts)
        self.done.append(Unit(events=events, windows=int(counts.sum()), steps=int(counts.max()),
                              seconds=seconds, submit_s=submit_s,
                              spans=np.stack([busy, first[busy], counts[busy]], 1)))
        if not self._sampling:
            return
        # A seeded draw decides which rounds are compared; the latest is
        # held until the next, so the window's last round always is.
        self._last = (counts, first, views)
        if self._rng.random() < 1.0 / self.traffic["sample_every"]:
            self._kept.append(self._last)
            self._last = None

    def answers(self) -> Answers:
        """The sampled rounds' answers and the last round's."""
        kept = self._kept + ([self._last] if self._last is not None else [])
        return Answers.join([_answers(*k) for k in kept])

    def count_check(self, ref: list[dict]) -> int:
        """(round, sensor) pairs whose count of closed windows is not the
        reference's: a window closes once the events fed make it certain."""
        fed = np.zeros(self.n_sensors, np.int64)
        before = np.zeros(self.n_sensors, np.int64)
        bad = 0
        for k, counts in enumerate(self._counts):
            fed += [T.chunk_len(lap, k) for lap in self.laps]
            after = np.array([np.searchsorted(r["ready"], f, side="right") for r, f in zip(ref, fed)])
            bad += int((counts != after - before).sum())
            before = after
        return bad

    def streams(self) -> list:
        return [T.replayed_stream(lap, len(self._counts)) for lap in self.laps]

    def close(self) -> None:
        self.fp = None


def _answers(counts: np.ndarray, first: np.ndarray, views: list) -> Answers:
    """One round's answers, every sensor's windows, as flat host arrays."""
    import torch

    stream = np.repeat(np.arange(len(counts)), counts)
    window = first[stream] + np.arange(len(stream)) - np.repeat(np.cumsum(counts) - counts, counts)
    cat = lambda get: torch.cat([get(v) for v in views]).numpy()  # noqa: E731
    return Answers(
        stream, window,
        np.concatenate([v.windows.starts for v in views]),
        np.concatenate([v.windows.stops for v in views]),
        np.concatenate([v.t_start_us for v in views]),
        {f: cat(lambda v, f=f: getattr(v.clusters, f)) for f in CLUSTER_FIELDS},
        {m: cat(lambda v, m=m: v.metrics[m]) for m in METRICS},
        {f: cat(lambda v, f=f: getattr(v.tracks, f)) for f in TRACK_FIELDS})
