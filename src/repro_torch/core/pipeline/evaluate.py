"""Accuracy evaluation (paper Sec. V-A: detections vs ground truth).

The port of ``repro.core.pipeline.evaluate``: a pipeline run at the
candidate floor, truth matching of every (window, slot, RSO) triple in
float32 on the run's device like the reference, then host bookkeeping
and scoring. :func:`collect_candidates` runs one recording;
:func:`collect_candidates_many` a whole suite through one core call of
:func:`run_many_scan`'s stacking and one batched match;
:func:`collect_candidates_fleet` the same suite through the live fleet
engine, one feed and one flush. :func:`threshold_sweep` scores every
threshold from one collection (the paper's Fig. 10b). The host oracles
are in :mod:`repro_torch.core.pipeline.oracles`.

Precision: the device matcher gates in float32, the numpy oracle in
float64, so the two agree except for a centroid within float32 rounding
(about 1e-4 px) of the 14 px gate, which the continuous synthetic suite
does not hit; the tests pin agreement on that suite.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.grid_clustering import Clusters
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.scan import _many_scan_raw, run_recording_scan
from repro_torch.distributed.sharding import assemble

if TYPE_CHECKING:
    from repro_torch.data.synthetic import Recording


@dataclasses.dataclass
class DetectionScore:
    tp: int = 0  # cluster >= threshold and is a true RSO
    fp: int = 0  # cluster >= threshold but star/noise
    fn: int = 0  # candidate RSO cluster rejected by threshold
    tn: int = 0  # star/noise candidate correctly rejected

    @property
    def accuracy(self) -> float:
        total = self.tp + self.fp + self.fn + self.tn
        return (self.tp + self.tn) / total if total else 0.0

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


@dataclasses.dataclass
class Candidates:
    """Candidate clusters (count, ground-truth flag) and, per visible
    (window, RSO) pair, the best count among clusters matched to it."""

    counts: np.ndarray  # (C,) candidate cluster event counts
    is_rso: np.ndarray  # (C,) bool
    object_best: np.ndarray  # (V,) best matched count per visible-object-window


def _floor_config(config: PipelineConfig, candidate_floor: int) -> PipelineConfig:
    floor_grid = dataclasses.replace(config.grid, min_events=candidate_floor)
    return dataclasses.replace(config, grid=floor_grid)


def track_table(tracks) -> np.ndarray:
    """An RSO trajectory table as (R, 6) float64 ``[x0, y0, vx, vy, ax, ay]``
    (4-column tables get zero accelerations)."""
    a = np.asarray(tracks, np.float64)
    if a.size == 0:
        return np.zeros((0, 6))
    a = a.reshape(-1, a.shape[-1])
    if a.shape[-1] == 4:
        a = np.concatenate([a, np.zeros((a.shape[0], 2))], axis=1)
    return a


def track_positions(tracks, ts):
    """Trajectory positions at times ``ts`` (seconds) for a (R, 6) table
    broadcast against ``ts[..., None]``; numpy arrays or tensors."""
    px = tracks[..., 0] + tracks[..., 2] * ts + 0.5 * tracks[..., 4] * ts * ts
    py = tracks[..., 1] + tracks[..., 3] * ts + 0.5 * tracks[..., 5] * ts * ts
    return px, py


def _match_core(counts, valid, cx, cy, ct, t_start, tracks, gate_px: float, max_samples):
    """Match every (window, slot) centroid against every RSO trajectory,
    in float32. Takes ``(..., W, K)`` clusters, ``(..., W)`` window
    origins, ``(..., R, 6)`` trajectories and an int or ``(...)`` tensor
    ``max_samples``, a leading axis batching recordings. Returns
    ``(is_rso (..., W, K), keep (..., W, K), best (..., W, R))``: ``keep``
    marks the window-major candidate prefix under ``max_samples``,
    ``best`` the max kept count matched to each (window, RSO) pair."""
    t_ev = t_start[..., :, None] + ct  # (..., W, K) us, recording-relative
    ts = t_ev[..., None] * 1e-6  # seconds, (..., W, K, 1)
    px, py = track_positions(tracks[..., None, None, :, :], ts)  # (..., W, K, R)
    dx = px - cx[..., None]
    dy = py - cy[..., None]
    matched = torch.sqrt(dx * dx + dy * dy) <= gate_px
    flat_valid = valid.flatten(-2)
    rank = torch.cumsum(flat_valid.to(torch.int32), -1) - 1
    ms = torch.as_tensor(max_samples, device=rank.device)
    keep = (flat_valid & (rank < ms[..., None])).reshape(valid.shape)
    contrib = torch.where(matched & keep[..., None], counts[..., None], 0)
    return matched.any(-1), keep, contrib.amax(-2)


# Padding trajectory for batched matching over recordings with different
# RSO counts: parked far outside the sensor, zero velocity, so it never
# gates.
_FAR_TRACK = (1e9, 1e9, 0.0, 0.0, 0.0, 0.0)


def _pad_tracks(tracks: list[np.ndarray]) -> np.ndarray:
    """``(R_i, 6)`` float32 trajectory tables stacked to ``(N, R_max, 6)``,
    padded with :data:`_FAR_TRACK` rows."""
    r_max = max((t.shape[0] for t in tracks), default=0)
    if not r_max:
        return np.zeros((len(tracks), 0, 6), np.float32)
    far = np.float32(_FAR_TRACK)
    return np.stack([np.concatenate([t, np.tile(far, (r_max - t.shape[0], 1))]) for t in tracks])


def _rebase_times(
    t_start_us: np.ndarray, tracks: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Window origins relative to the first window (float32) and the
    trajectories advanced to the same origin in float64, then cast."""
    t_ref_us = int(t_start_us[0]) if len(t_start_us) else 0
    t_rel = (t_start_us - t_ref_us).astype(np.float32)
    shifted = track_table(tracks)
    if shifted.size:
        dt = t_ref_us * 1e-6
        shifted[:, 0] += shifted[:, 2] * dt + 0.5 * shifted[:, 4] * dt * dt
        shifted[:, 1] += shifted[:, 3] * dt + 0.5 * shifted[:, 5] * dt * dt
        shifted[:, 2] += shifted[:, 4] * dt
        shifted[:, 3] += shifted[:, 5] * dt
    return t_rel, shifted.astype(np.float32)


def _visible_objects(
    recording: Recording, stops: np.ndarray, n_rso: int, min_truth_events: int
) -> np.ndarray:
    """(W, R) bool: (window, RSO) pairs with at least ``min_truth_events``
    true events (host side, from the ground-truth labels)."""
    from repro_torch.data.synthetic import KIND_RSO

    w_count = len(stops)
    n_true = np.zeros((w_count, n_rso), np.int64)
    rso_ev = np.flatnonzero(np.asarray(recording.kind) == KIND_RSO)
    if rso_ev.size and w_count:
        ev_w = np.searchsorted(stops, rso_ev, side="right")
        in_range = ev_w < w_count
        np.add.at(
            n_true,
            (ev_w[in_range], np.asarray(recording.obj)[rso_ev[in_range]]),
            1,
        )
    return n_true >= min_truth_events


def _assemble_candidates(
    recording: Recording,
    stops: np.ndarray,  # (W,) window slice stops
    counts: np.ndarray,  # (W, K)
    is_rso: np.ndarray,  # (W, K)
    keep: np.ndarray,  # (W, K)
    best: np.ndarray,  # (W, R)
    min_truth_events: int,
) -> Candidates:
    n_rso = best.shape[-1]
    keep_flat = keep.reshape(-1)
    visible = _visible_objects(recording, stops, n_rso, min_truth_events)
    return Candidates(
        counts.reshape(-1)[keep_flat].astype(np.int32),
        np.asarray(is_rso.reshape(-1)[keep_flat], bool),
        np.asarray(best[visible], np.int32),
    )


def collect_candidates(
    recording: Recording,
    config: PipelineConfig = PipelineConfig(),
    candidate_floor: int = 2,
    max_samples: int | None = None,
    gate_px: float = 14.0,
    min_truth_events: int = 3,
    device: str | torch.device = DEFAULT_DEVICE,
) -> Candidates:
    """Run the pipeline once at ``candidate_floor`` and collect candidates
    (truth matching on the device, visibility bookkeeping on the host)."""
    result = run_recording_scan(
        recording, _floor_config(config, candidate_floor), with_tracking=False,
        device=device,
    )
    windows = result.windows
    cl = result.clusters
    dev = cl.count.device
    t_rel, tracks = _rebase_times(windows.t_start_us, recording.rso_tracks)
    k = cl.count.shape[-1]
    ms = windows.num_windows * k if max_samples is None else max_samples
    is_rso, keep, best = _match_core(
        cl.count, cl.valid, cl.centroid_x, cl.centroid_y, cl.centroid_t,
        torch.as_tensor(t_rel, device=dev), torch.as_tensor(tracks, device=dev),
        gate_px, ms,
    )
    host = lambda a: a.cpu().numpy()
    return _assemble_candidates(
        recording, windows.stops, host(cl.count), host(is_rso), host(keep),
        host(best), min_truth_events,
    )


def _match_suite(recordings, cl, t_grid, rows, stops, tracks, max_samples, gate_px,
                 min_truth_events) -> list[Candidates]:
    """One batched match over a suite's stacked ``(R, W, K)`` clusters:
    recording r's real windows are the rows ``rows[r]`` of its block, with
    origins ``t_grid[r, rows[r]]`` (float32, rebased), window stops
    ``stops[r]`` and rebased trajectories ``tracks[r]``; the other rows
    hold no valid cluster. Returns each recording's candidates."""
    dev = cl.count.device
    k = cl.count.shape[-1]
    ms = [len(r) * k if max_samples is None else max_samples for r in rows]
    is_rso, keep, best = _match_core(
        cl.count, cl.valid, cl.centroid_x, cl.centroid_y, cl.centroid_t,
        torch.as_tensor(t_grid, device=dev), torch.as_tensor(_pad_tracks(tracks), device=dev),
        gate_px, torch.as_tensor(ms, dtype=torch.int32, device=dev),
    )
    counts, is_rso, keep, best = (a.cpu().numpy() for a in (cl.count, is_rso, keep, best))
    return [
        _assemble_candidates(rec, stops[r], counts[r][rows[r]], is_rso[r][rows[r]],
                             keep[r][rows[r]], best[r][rows[r]][:, :tracks[r].shape[0]],
                             min_truth_events)
        for r, rec in enumerate(recordings)
    ]


def collect_candidates_many(
    recordings: list[Recording],
    config: PipelineConfig = PipelineConfig(),
    candidate_floor: int = 2,
    max_samples: int | None = None,
    gate_px: float = 14.0,
    min_truth_events: int = 3,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[Candidates]:
    """Candidates for a whole suite: one core call over every recording's
    windows (stacked and padded to a common count, as :func:`run_many_scan`
    does) and one batched match (trajectories padded to a common RSO count
    with far-away parked tracks). Each recording's result equals
    :func:`collect_candidates` of it; padded windows hold no valid cluster
    and padded tracks never gate."""
    if not recordings:
        return []
    windowed, (_, clusters, _, _) = _many_scan_raw(
        recordings, _floor_config(config, candidate_floor), False, device)
    t_grid = np.zeros(clusters.count.shape[:2], np.float32)
    rows, tracks = [], []
    for r, (rec, w) in enumerate(zip(recordings, windowed)):
        t_rel, shifted = _rebase_times(w.t_start_us, rec.rso_tracks)
        t_grid[r, :w.num_windows] = t_rel
        rows.append(np.arange(w.num_windows))
        tracks.append(shifted)
    return _match_suite(recordings, clusters, t_grid, rows, [w.stops for w in windowed], tracks,
                        max_samples, gate_px, min_truth_events)


def collect_candidates_fleet(
    recordings: list[Recording],
    config: PipelineConfig = PipelineConfig(),
    candidate_floor: int = 2,
    max_samples: int | None = None,
    gate_px: float = 14.0,
    min_truth_events: int = 3,
    mesh=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[Candidates]:
    """Candidates for a whole suite through the live fleet engine: each
    recording is one sensor of a ``FleetPipeline(with_tracking=False)``
    over the ragged wire, fed whole in one round, then flushed, and one
    batched match runs over the stacked fleet outputs. Padded window rows
    hold no valid cluster, so each recording's result equals
    :func:`collect_candidates_many`'s. ``mesh`` (a mesh of devices with a
    ``sensor`` axis) shards the fleet, which changes no result."""
    from repro_torch.core.pipeline.fleet import FleetPipeline

    if not recordings:
        return []
    fleet = FleetPipeline(_floor_config(config, candidate_floor), n_sensors=len(recordings),
                          with_tracking=False, mesh=mesh, device=device)
    head = fleet.feed([(r.x, r.y, r.t, r.p) for r in recordings])
    tail = fleet.flush()
    parts = [p for p in (head, tail) if p.clusters is not None]
    if not parts:  # nothing closed anywhere (all-empty recordings)
        empty = lambda: Candidates(np.zeros(0, np.int32), np.zeros(0, bool), np.zeros(0, np.int32))  # noqa: E731
        return [empty() for _ in recordings]
    cl = Clusters(*(torch.cat([assemble(a) for a in f], dim=1)
                    for f in zip(*(p.clusters for p in parts))))
    # Sensor s fills rows [0, n_head) of the feed's block and [w_head,
    # w_head + n_tail) of the flush's.
    offsets = np.cumsum([0] + [p.clusters.count.shape[1] for p in parts])[:-1]
    t_grid = np.zeros(cl.count.shape[:2], np.float32)
    rows, stops, tracks = [], [], []
    for s, rec in enumerate(recordings):
        t_rel, shifted = _rebase_times(
            np.concatenate([p.windows[s].t_start_us for p in parts]), rec.rso_tracks)
        rows.append(np.concatenate(
            [off + np.arange(int(p.n_windows[s])) for off, p in zip(offsets, parts)]
        ).astype(np.int64))
        t_grid[s, rows[-1]] = t_rel
        stops.append(np.concatenate([p.windows[s].stops for p in parts]))
        tracks.append(shifted)
    return _match_suite(recordings, cl, t_grid, rows, stops, tracks, max_samples, gate_px,
                        min_truth_events)


def score_threshold(cand: Candidates, thr: int) -> DetectionScore:
    passed = cand.counts >= thr
    return DetectionScore(
        tp=int(np.sum(passed & cand.is_rso)),
        fp=int(np.sum(passed & ~cand.is_rso)),
        fn=int(np.sum(cand.object_best < thr)),
        tn=int(np.sum(~passed & ~cand.is_rso)),
    )


def merge_candidates(cands: list[Candidates]) -> Candidates:
    return Candidates(
        np.concatenate([c.counts for c in cands]) if cands else np.zeros(0, np.int32),
        np.concatenate([c.is_rso for c in cands]) if cands else np.zeros(0, bool),
        np.concatenate([c.object_best for c in cands]) if cands else np.zeros(0, np.int32),
    )


def evaluate_detection(
    recording: Recording,
    config: PipelineConfig = PipelineConfig(),
    min_events: int | None = None,
    candidate_floor: int = 2,
    max_samples: int | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> DetectionScore:
    """Score the min_events detector against simulator ground truth
    (the paper's Fig. 10b / Sec. V-A protocol)."""
    thr = config.grid.min_events if min_events is None else min_events
    cand = collect_candidates(
        recording, config, candidate_floor, max_samples, device=device
    )
    return score_threshold(cand, thr)


def threshold_sweep(
    recordings: list[Recording],
    thresholds: tuple[int, ...] = (2, 3, 4, 5, 6, 8, 10),
    config: PipelineConfig = PipelineConfig(),
    max_samples_per_recording: int | None = None,
    driver: str = "scan",
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict[int, DetectionScore]:
    """Accuracy against ``min_events`` over a validation suite (the
    paper's Fig. 10b): candidates collected once, every threshold scored
    on the host. ``driver="scan"`` collects through one stacked core call
    (:func:`collect_candidates_many`), ``driver="fleet"`` through the live
    fleet engine (:func:`collect_candidates_fleet`); the scores are the
    same."""
    if driver == "scan":
        cands = collect_candidates_many(
            recordings, config, max_samples=max_samples_per_recording, device=device)
    elif driver == "fleet":
        cands = collect_candidates_fleet(
            recordings, config, max_samples=max_samples_per_recording, device=device)
    else:
        raise ValueError(f"unknown threshold_sweep driver: {driver!r}")
    cand = merge_candidates(cands)
    return {thr: score_threshold(cand, thr) for thr in thresholds}
