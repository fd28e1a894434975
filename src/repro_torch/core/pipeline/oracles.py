"""Host oracles for the device candidate collection.

The port of ``repro.core.pipeline.oracles``:
:func:`collect_candidates_numpy` matches the scan's outputs in float64
numpy, :func:`collect_candidates_loop` is the first-principles loop over
windows and clusters on the loop driver's per-window stage. Both are
semantically identical to :func:`~repro_torch.core.pipeline.evaluate.
collect_candidates`, so the device path stays testable against
independent code.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.events import dual_threshold_batches
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.evaluate import (
    Candidates,
    _floor_config,
    _visible_objects,
    track_positions,
    track_table,
)
from repro_torch.core.pipeline.scan import run_recording_scan
from repro_torch.core.pipeline.window_core import make_process_window

if TYPE_CHECKING:
    from repro_torch.data.synthetic import Recording


def collect_candidates_numpy(
    recording: Recording,
    config: PipelineConfig = PipelineConfig(),
    candidate_floor: int = 2,
    max_samples: int | None = None,
    gate_px: float = 14.0,
    min_truth_events: int = 3,
    device: str | torch.device = DEFAULT_DEVICE,
) -> Candidates:
    """Truth matching in float64 numpy over the scan's outputs (run on
    ``device``), with :func:`collect_candidates`' ordering and
    bookkeeping."""
    result = run_recording_scan(
        recording, _floor_config(config, candidate_floor), with_tracking=False, device=device)
    windows = result.windows
    cl = result.clusters
    counts = cl.count.cpu().numpy()  # (W, K)
    valid = cl.valid.cpu().numpy()
    cx, cy, ct = (a.cpu().numpy().astype(np.float64)
                  for a in (cl.centroid_x, cl.centroid_y, cl.centroid_t))
    w_count, k = counts.shape
    tracks = track_table(recording.rso_tracks)
    n_rso = tracks.shape[0]

    # Every (window, slot) centroid against every trajectory at the
    # cluster's mean event time.
    t_ev = windows.t_start_us[:, None].astype(np.float64) + ct  # (W, K)
    px, py = track_positions(tracks[None, None, :, :], t_ev[:, :, None] * 1e-6)  # (W, K, R)
    matched = np.hypot(px - cx[:, :, None], py - cy[:, :, None]) <= gate_px

    # Window-major, slot order, as the loop.
    flat_valid = valid.reshape(-1)
    if max_samples is None:
        keep_flat = flat_valid
    else:
        keep_flat = flat_valid & (np.cumsum(flat_valid) - 1 < max_samples)
    keep = keep_flat.reshape(w_count, k)
    visible = _visible_objects(recording, windows.stops, n_rso, min_truth_events)
    contrib = np.where(matched & keep[:, :, None], counts[:, :, None], 0)  # (W, K, R)
    best = contrib.max(axis=1) if k else np.zeros((w_count, n_rso), counts.dtype)
    return Candidates(
        counts.reshape(-1)[keep_flat].astype(np.int32),
        np.asarray(matched.any(axis=-1).reshape(-1)[keep_flat], bool),
        np.asarray(best[visible], np.int32),
    )


def collect_candidates_loop(
    recording: Recording,
    config: PipelineConfig = PipelineConfig(),
    candidate_floor: int = 2,
    max_samples: int | None = None,
    gate_px: float = 14.0,
    min_truth_events: int = 3,
    device: str | torch.device = DEFAULT_DEVICE,
) -> Candidates:
    """The per-window, per-cluster Python loop (the first-principles
    oracle), on the loop driver's windows and per-window stage on
    ``device``."""
    from repro_torch.data.synthetic import KIND_RSO

    floor_cfg = _floor_config(config, candidate_floor)
    process_window = make_process_window(floor_cfg)
    counts_out: list[int] = []
    truth_out: list[bool] = []
    object_best: list[int] = []
    n_rso = track_table(recording.rso_tracks).shape[0]

    for batch, sl in dual_threshold_batches(
        recording.x, recording.y, recording.t, recording.p, floor_cfg.batcher, device
    ):
        clusters, _ = process_window(batch)
        counts, valid, cxs, cys, cts = (
            a.cpu().numpy() for a in (clusters.count, clusters.valid, clusters.centroid_x,
                                      clusters.centroid_y, clusters.centroid_t))
        t0 = float(recording.t[sl.start])
        # Object level: the best matched count per visible RSO.
        kinds = recording.kind[sl]
        objs = recording.obj[sl]
        best = {}
        for r in range(n_rso):
            if int(np.sum((kinds == KIND_RSO) & (objs == r))) >= min_truth_events:
                best[r] = 0
        for k in range(len(counts)):
            if not valid[k]:
                continue
            if max_samples is not None and len(counts_out) >= max_samples:
                break
            cx, cy = float(cxs[k]), float(cys[k])
            t_ev = t0 + float(cts[k])
            matched = False
            for r in range(n_rso):
                px, py = recording.rso_position(r, np.array([t_ev]))
                if np.hypot(px[0] - cx, py[0] - cy) <= gate_px:
                    matched = True
                    if r in best:
                        best[r] = max(best[r], int(counts[k]))
            counts_out.append(int(counts[k]))
            truth_out.append(matched)
        object_best.extend(best.values())
    return Candidates(
        np.asarray(counts_out, np.int32),
        np.asarray(truth_out, bool),
        np.asarray(object_best, np.int32),
    )
