"""The comparison that decides ``correct``.

A run hands in its answers as flat arrays, one row a window: the stream
(a recording or a sensor) and the window's index in it, its bounds, its
``(K,)`` clusters and metrics and the ``(T,)`` tracker state after it, all
host arrays. Each row is held against the plain reference's answer for
the same window. Integer answers count their mismatches and are held to
0; float answers give the widest gap, field by field, as a share of the
median size of the reference's value over the slots compared, and are
held to the limits the workload file states (set from the readings in
``PERF.md``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from harness.reference import CLUSTER_FIELDS, METRICS, TRACK_FIELDS

INT_CLUSTER = ("count", "cell_x", "cell_y", "valid")
FLOAT_CLUSTER = ("centroid_x", "centroid_y", "centroid_t")
INT_TRACK = ("hits", "misses", "age", "active")
FLOAT_TRACK = ("x", "y", "vx", "vy", "entropy")
CHECKS = ("windows", "clusters", "detections", "tracks", "centroid_gap", "metric_gap", "track_gap")
WINDOW_FIELDS = ("starts", "stops", "t_start")


@dataclasses.dataclass
class Answers:
    """Rows of windows: ``stream`` and ``window`` say which; the rest is
    what was answered for it."""

    stream: np.ndarray
    window: np.ndarray
    starts: np.ndarray
    stops: np.ndarray
    t_start: np.ndarray
    clusters: dict
    metrics: dict
    tracks: dict

    @staticmethod
    def join(parts: list["Answers"]) -> "Answers":
        cat = lambda get: np.concatenate([get(p) for p in parts])  # noqa: E731
        return Answers(
            cat(lambda p: p.stream), cat(lambda p: p.window),
            *(cat(lambda p, f=f: getattr(p, f)) for f in WINDOW_FIELDS),
            {f: cat(lambda p, f=f: p.clusters[f]) for f in CLUSTER_FIELDS},
            {m: cat(lambda p, m=m: p.metrics[m]) for m in METRICS},
            {f: cat(lambda p, f=f: p.tracks[f]) for f in TRACK_FIELDS})


def reference_rows(ref: list[dict], stream: np.ndarray, window: np.ndarray) -> tuple[Answers, np.ndarray]:
    """The reference's answers at ``(stream, window)``, and the mask of
    the rows it has (a window past a stream's reference has none)."""
    lengths = np.array([len(r["starts"]) for r in ref], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    have = window < lengths[stream]
    idx = offsets[stream[have]] + window[have]
    flat = lambda get: np.concatenate([get(r) for r in ref])[idx]  # noqa: E731
    rows = Answers(
        stream[have], window[have],
        *(flat(lambda r, f=f: r[f]) for f in WINDOW_FIELDS),
        {f: flat(lambda r, f=f: r["clusters"][f]) for f in CLUSTER_FIELDS},
        {m: flat(lambda r, m=m: r["metrics"][m]) for m in METRICS},
        {f: flat(lambda r, f=f: r["tracks"][f]) for f in TRACK_FIELDS})
    return rows, have


def _gap(got: np.ndarray, want: np.ndarray, mask: np.ndarray) -> float:
    """The widest ``|got - want|`` over the masked entries, as a share of
    the median ``|want|`` of the nonzero masked ones (1 if none)."""
    g = np.asarray(got, np.float64)[mask]
    w = np.asarray(want, np.float64)[mask]
    if not len(w):
        return 0.0
    nz = np.abs(w[w != 0])
    scale = float(np.median(nz)) if len(nz) else 1.0
    return float(np.abs(g - w).max() / scale)


def compare(ans: Answers, ref: list[dict], confirm_hits: int, count_mismatch: int = 0) -> dict:
    """The numbers compared. ``count_mismatch``: the (unit, stream) pairs
    whose count of closed windows is not the reference's, added to
    ``windows``."""
    want, have = reference_rows(ref, ans.stream, ans.window)
    sel = lambda a: np.asarray(a)[have]  # noqa: E731
    out = dict.fromkeys(CHECKS, 0)
    out["windows"] = int(count_mismatch) + int((~have).sum())
    for f in WINDOW_FIELDS:
        out["windows"] += int((sel(getattr(ans, f)) != getattr(want, f)).sum())
    for f in INT_CLUSTER:
        out["clusters"] += int((sel(ans.clusters[f]) != want.clusters[f]).sum())
    got_valid = sel(ans.clusters["valid"]).astype(bool)
    either = got_valid | want.clusters["valid"].astype(bool)
    out["centroid_gap"] = max(_gap(sel(ans.clusters[f]), want.clusters[f], either) for f in FLOAT_CLUSTER)
    out["metric_gap"] = max(_gap(sel(ans.metrics[m]), want.metrics[m], either) for m in METRICS)
    for f in INT_TRACK:
        out["tracks"] += int((sel(ans.tracks[f]) != want.tracks[f]).sum())
    live = sel(ans.tracks["active"]).astype(bool) | want.tracks["active"].astype(bool)
    out["track_gap"] = max(_gap(sel(ans.tracks[f]), want.tracks[f], live) for f in FLOAT_TRACK)
    confirmed = lambda t: t["active"].astype(bool) & (t["hits"] >= confirm_hits)  # noqa: E731
    got_tracks = {f: sel(ans.tracks[f]) for f in ("active", "hits")}
    out["detections"] = (int((got_valid != want.clusters["valid"].astype(bool)).sum())
                         + int((confirmed(got_tracks) != confirmed(want.tracks)).sum()))
    return out


def verdict(checks: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """Whether every number lies within its limit, and the ``(name,
    number, limit)`` rows in the order of :data:`CHECKS`."""
    rows = [(k, checks[k], limits[k]) for k in CHECKS]
    return all(v <= lim for _, v, lim in rows), rows
