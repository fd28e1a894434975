"""The traced stretch of a ``--trace 1`` run, reduced to plain arrays.

``torch.profiler`` records the host's ranges (the program's
``record_function`` ranges and the harness's own ``bench.*`` spans), the
CUDA runtime's launch calls and the device's kernels, copies and fills,
each launch tied to its kernel by the runtime's correlation id; they are
read from the profiler's Chrome trace, whose event categories are the
same across PyTorch versions. The
per-layer metrics read from :class:`Trace`: the host time of a range, the
device time of the kernels launched inside ranges of a name, and the
union of the device's busy intervals. Every time here is in the
profiler's clock, in nanoseconds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT_SPAN = "bench.unit"  # the drivers' span around a unit's work


@dataclasses.dataclass
class Trace:
    """``ranges``: name -> ``(n, 2)`` start and end of each host range;
    ``device``: ``(name, kind, start, end, correlation)`` of each device
    operation; ``launch_at``: correlation -> the host time of its launch
    call."""

    ranges: dict[str, np.ndarray]
    device: list[tuple[str, str, int, int, int]]
    launch_at: dict[int, int]

    @property
    def bounds(self) -> tuple[int, int]:
        """The traced stretch: from the first unit's start to the last's end."""
        units = self.ranges.get(UNIT_SPAN, np.zeros((0, 2), np.int64))
        if not len(units):
            raise ValueError("the trace holds no unit span")
        return int(units[:, 0].min()), int(units[:, 1].max())

    @property
    def window_s(self) -> float:
        lo, hi = self.bounds
        return (hi - lo) * 1e-9

    def host_s(self, name: str) -> float:
        """Seconds spent inside ranges named ``name`` (nested ones once)."""
        return _union_length(self.ranges.get(name, np.zeros((0, 2), np.int64))) * 1e-9

    def busy_intervals(self) -> np.ndarray:
        """The device's busy intervals inside the stretch, merged."""
        lo, hi = self.bounds
        iv = np.array([(max(s, lo), min(e, hi)) for _, _, s, e, _ in self.device
                       if e > lo and s < hi], np.int64).reshape(-1, 2)
        return _merge(iv)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9

    def launched_in_s(self, names: tuple[str, ...]) -> float | None:
        """Device seconds of the operations launched inside a range of one
        of ``names``; ``None`` when no such range holds a launch."""
        spans = _merge(np.concatenate(
            [self.ranges.get(n, np.zeros((0, 2), np.int64)) for n in names]))
        total, found = 0, False
        for _, kind, s, e, corr in self.device:
            at = self.launch_at.get(corr)
            if kind != "kernel" or at is None or not _inside(spans, at):
                continue
            total += e - s
            found = True
        return total * 1e-9 if found else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time by the innermost host range open at each gap's middle."""
        by_op: dict[str, int] = defaultdict(int)
        lo, hi = self.bounds
        for name, _, s, e, _ in self.device:
            if e > lo and s < hi:
                by_op[name[:160]] += min(e, hi) - max(s, lo)
        busy = self.busy_intervals()
        edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        names = ["(no range)"] + list(self.ranges)
        best = np.full(len(mids), np.iinfo(np.int64).max)
        label = np.zeros(len(mids), np.int64)
        for j, name in enumerate(names[1:], 1):
            iv = self.ranges[name]
            iv = iv[np.argsort(iv[:, 0], kind="stable")]
            i = np.searchsorted(iv[:, 0], mids, side="right") - 1
            ok = i >= 0
            length = np.where(ok, iv[np.maximum(i, 0), 1] - iv[np.maximum(i, 0), 0], 0)
            ok &= mids < iv[np.maximum(i, 0), 1]
            take = ok & (length < best)
            best[take], label[take] = length[take], j
        by_host: dict[str, int] = defaultdict(int)
        for j, w in zip(label.tolist(), (gaps[:, 1] - gaps[:, 0]).tolist()):
            by_host[names[j]] += w
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return dict(device_ops=[[n, v * 1e-9] for n, v in order(by_op)],
                    idle_gaps=[[n, v * 1e-9] for n, v in order(by_host)])


def _merge(iv: np.ndarray) -> np.ndarray:
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.int64)


def _union_length(iv: np.ndarray) -> int:
    m = _merge(np.asarray(iv, np.int64).reshape(-1, 2))
    return int((m[:, 1] - m[:, 0]).sum())


def _inside(spans: np.ndarray, t: int) -> bool:
    """Whether ``t`` lies in one of the merged, sorted ``spans``."""
    i = int(np.searchsorted(spans[:, 0], t, side="right")) - 1
    return i >= 0 and t < spans[i, 1]


def from_events(events: list[dict]) -> Trace:
    """A :class:`Trace` from the events of a Chrome trace as
    ``torch.profiler`` exports it (``cat``, ``name``, ``ts`` and ``dur``
    in microseconds, ``args.correlation``)."""
    ranges: dict[str, list] = defaultdict(list)
    device, launch_at = [], {}
    for ev in events:
        kind = ev.get("cat")
        if ev.get("ph") != "X" or kind is None:
            continue
        start = int(round(float(ev["ts"]) * 1e3))
        end = start + int(round(float(ev.get("dur", 0)) * 1e3))
        corr = ev.get("args", {}).get("correlation")
        if kind == "user_annotation":
            ranges[ev["name"]].append((start, end))
        elif kind in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_at[int(corr)] = start
        elif kind in DEVICE_KINDS:
            device.append((ev["name"], kind, start, end, -1 if corr is None else int(corr)))
    return Trace({n: np.asarray(v, np.int64).reshape(-1, 2) for n, v in ranges.items()},
                 device, launch_at)


def from_profiler(prof) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``, by way
    of its Chrome trace, written to a temporary file and removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return from_events(doc["traceEvents"] if isinstance(doc, dict) else doc)
