"""Accuracy evaluation (paper Sec. V-A: detections vs ground truth).

The port of the part of ``repro.core.pipeline.evaluate`` that
:func:`evaluate_detection` needs: one pipeline run at the candidate
floor, truth matching of every (window, slot, RSO) triple in float32 on
the run's device like the reference, then host bookkeeping and scoring.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.scan import run_recording_scan

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


def _match_core(counts, valid, cx, cy, ct, t_start, tracks, gate_px: float, max_samples: int):
    """Match every (window, slot) centroid against every RSO trajectory,
    in float32. Returns ``(is_rso (W, K), keep (W, K), best (W, R))``:
    ``keep`` marks the window-major candidate prefix under
    ``max_samples``, ``best`` the max kept count matched to each pair."""
    t_ev = t_start[:, None] + ct  # (W, K) us, recording-relative
    ts = t_ev[:, :, None] * 1e-6  # seconds, (W, K, 1)
    px, py = track_positions(tracks[None, None, :, :], ts)  # (W, K, R)
    dx = px - cx[:, :, None]
    dy = py - cy[:, :, None]
    matched = torch.sqrt(dx * dx + dy * dy) <= gate_px
    flat_valid = valid.reshape(-1)
    rank = torch.cumsum(flat_valid.to(torch.int32), 0) - 1
    keep = (flat_valid & (rank < max_samples)).reshape(valid.shape)
    contrib = torch.where(matched & keep[:, :, None], counts[:, :, None], 0)
    return matched.any(-1), keep, contrib.amax(1)


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


def score_threshold(cand: Candidates, thr: int) -> DetectionScore:
    passed = cand.counts >= thr
    return DetectionScore(
        tp=int(np.sum(passed & cand.is_rso)),
        fp=int(np.sum(passed & ~cand.is_rso)),
        fn=int(np.sum(cand.object_best < thr)),
        tn=int(np.sum(~passed & ~cand.is_rso)),
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
