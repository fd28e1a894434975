"""The archive: recorded nights processed offline, many recordings a call.

Each pass hands the same recordings to ``run_many_scan`` (one core call
over all of them, windowed on the host, stacked, the window stages in
blocks on the device, the tracker stepping every recording at once) and
then brings every recording's detections to the host: clusters, metrics
and the tracker state after each window, a field of all recordings in
one copy. A pass ends when they are on the host.
"""
from __future__ import annotations

import time

import numpy as np

from harness import traffic as T
from harness.bench import Unit
from harness.compare import Answers
from harness.reference import CLUSTER_FIELDS, METRICS, TRACK_FIELDS
from harness.trace import UNIT_SPAN


class Session:
    final = True  # a recording's trailing window closes at its last event

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.device = config, traffic, device
        self.events = T.recordings(traffic, seed)
        self._last: Answers | None = None  # the latest pass's detections
        self.done: list[Unit] = []

    def setup(self) -> None:
        from repro_torch.core.pipeline import config_from_dict, run_many_scan
        from repro_torch.data.synthetic import Recording

        self._scan = run_many_scan
        self.cfg = config_from_dict(self.config["pipeline"])
        self.inputs = [
            Recording(e.x, e.y, e.t, e.p, kind=np.zeros(len(e), np.int32),
                      obj=np.full(len(e), -1, np.int32), rso_tracks=np.zeros((0, 4)),
                      duration_us=e.duration_us, name=f"archive-{i}")
            for i, e in enumerate(self.events)
        ]
        for _ in range(self.traffic["warmup_passes"]):
            self.step()

    def step(self) -> None:
        """One pass over every recording, its detections brought to the host."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(UNIT_SPAN):
            results = self._scan(self.inputs, self.cfg, True, device=self.device)
            self._last = _fetch(results)
        seconds = time.perf_counter() - t0
        n = [r.num_windows for r in results]
        self.done.append(Unit(events=sum(len(e) for e in self.events), windows=sum(n),
                              steps=max(n, default=0), seconds=seconds,
                              spans=np.array([(s, 0, k) for s, k in enumerate(n)], np.int64)))

    def drain(self) -> None:
        """A pass ends on the host: nothing is left in flight."""

    def answers(self) -> Answers:
        """The last pass's detections, every window of every recording."""
        return self._last

    def count_check(self, ref: list[dict]) -> int:
        """Windows the last pass lacks against the reference, a recording."""
        n = np.bincount(self._last.stream, minlength=len(ref))
        return int(sum(max(len(r["starts"]) - k, 0) for r, k in zip(ref, n)))

    def streams(self) -> list:
        return self.events

    def close(self) -> None:
        self.inputs = None


def _fetch(results: list) -> Answers:
    """Every recording's results as flat host arrays, a field at a time."""
    import torch

    n = np.array([r.num_windows for r in results], np.int64)
    cat = lambda get: torch.cat([get(r) for r in results]).cpu().numpy()  # noqa: E731
    return Answers(
        np.repeat(np.arange(len(results)), n), np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n),
        np.concatenate([r.windows.starts for r in results]),
        np.concatenate([r.windows.stops for r in results]),
        np.concatenate([r.t_start_us for r in results]),
        {f: cat(lambda r, f=f: getattr(r.clusters, f)) for f in CLUSTER_FIELDS},
        {m: cat(lambda r, m=m: r.metrics[m]) for m in METRICS},
        {f: cat(lambda r, f=f: getattr(r.tracks, f)) for f in TRACK_FIELDS})
