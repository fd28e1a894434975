"""Track formation across event windows (paper Sec. III-D, Fig. 8).

The port of ``repro.core.tracking``: a fixed-capacity constant-velocity
(alpha-beta) tracker with greedy nearest-neighbour association inside a
gate, hit/miss bookkeeping, confirmation after ``confirm_hits`` hits and
removal after ``max_misses`` misses. The tracker is the only stage that
carries state from window to window, so it runs as a Python loop over
windows on the run's device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.grid_clustering import Clusters

MAX_TRACKS = 16


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    gate: float = 24.0  # px association gate (1.5 cells)
    alpha: float = 0.6  # position gain
    beta: float = 0.25  # velocity gain
    confirm_hits: int = 3
    max_misses: int = 2
    max_tracks: int = MAX_TRACKS


class TrackState(NamedTuple):
    x: torch.Tensor  # (T,) float32
    y: torch.Tensor  # (T,)
    vx: torch.Tensor  # (T,) px / window
    vy: torch.Tensor  # (T,)
    hits: torch.Tensor  # (T,) int32
    misses: torch.Tensor  # (T,) int32
    age: torch.Tensor  # (T,) int32
    active: torch.Tensor  # (T,) bool
    entropy: torch.Tensor  # (T,) float32 EMA of cluster Shannon entropy


_FIELD_DTYPES = {
    "x": torch.float32, "y": torch.float32, "vx": torch.float32,
    "vy": torch.float32, "hits": torch.int32, "misses": torch.int32,
    "age": torch.int32, "active": torch.bool, "entropy": torch.float32,
}


def init_tracks(
    config: TrackerConfig = TrackerConfig(),
    device: str | torch.device = DEFAULT_DEVICE,
) -> TrackState:
    dev = resolve_device(device)
    t = config.max_tracks
    return TrackState(
        **{f: torch.zeros((t,), dtype=d, device=dev) for f, d in _FIELD_DTYPES.items()}
    )


def tracks_from_numpy(
    state: dict[str, np.ndarray], device: str | torch.device = DEFAULT_DEVICE
) -> TrackState:
    """A ``TrackState`` from a dict of numpy arrays keyed by field name,
    e.g. ``reference_state._asdict()`` converted leaf by leaf: the carry
    that lets a run start mid-stream from another implementation's state."""
    dev = resolve_device(device)
    return TrackState(
        **{
            f: torch.as_tensor(np.array(state[f]), dtype=d, device=dev)
            for f, d in _FIELD_DTYPES.items()
        }
    )


def tracks_to_numpy(state: TrackState) -> dict[str, np.ndarray]:
    """The tracker carry as a dict of numpy arrays (inverse of
    :func:`tracks_from_numpy`)."""
    return {f: getattr(state, f).cpu().numpy() for f in TrackState._fields}


def _greedy_assign(cost: torch.Tensor, gate: float) -> torch.Tensor:
    """Greedy min-cost assignment. ``cost`` (..., T, K) -> (..., T)
    detection index or -1; tracks pick in index order, ``argmin`` takes
    the first index, and each detection is used at most once. Leading
    dims are independent problems (sensors of a fleet)."""
    t, k = cost.shape[-2:]
    # +inf on detections already taken; cost + 0.0 leaves a free entry
    # unchanged, so this is the reference's where(assigned, inf, cost).
    taken = torch.zeros(cost.shape[:-2] + (k,), dtype=cost.dtype, device=cost.device)
    out = []
    for ti in range(t):
        row = cost[..., ti, :] + taken
        j = torch.argmin(row, dim=-1, keepdim=True)  # (..., 1)
        ok = row.gather(-1, j) <= gate
        taken.scatter_reduce_(-1, j, torch.where(ok, float("inf"), 0.0), reduce="amax")
        out.append(torch.where(ok, j, -1))
    return torch.cat(out, dim=-1).to(torch.int32)


def tracker_step(
    state: TrackState,
    clusters: Clusters,
    cluster_entropy: torch.Tensor,
    config: TrackerConfig = TrackerConfig(),
) -> tuple[TrackState, torch.Tensor]:
    """One tracker update over (..., K) clusters and (..., T) tracks.
    Returns (new_state, (..., T) assignment into the clusters or -1).

    Leading dims batch independent trackers (the sensors of a fleet);
    every step is elementwise, a gather or a reduction over the last dim,
    so a batched update equals the single-sensor one to the bit."""
    t = config.max_tracks
    k = clusters.valid.shape[-1]
    dev = clusters.valid.device
    lead = clusters.valid.shape[:-1]
    take = lambda a, i: a.gather(-1, i)  # noqa: E731
    # Predict.
    px = state.x + state.vx
    py = state.y + state.vy
    # Cost = distance, inf for inactive tracks / invalid detections.
    dx = px[..., :, None] - clusters.centroid_x[..., None, :]
    dy = py[..., :, None] - clusters.centroid_y[..., None, :]
    dist = torch.sqrt(dx * dx + dy * dy)
    cost = torch.where(
        state.active[..., :, None] & clusters.valid[..., None, :], dist, float("inf")
    )
    assign = _greedy_assign(cost, config.gate)
    matched = assign >= 0
    ai = torch.clamp(assign, 0, k - 1).to(torch.int64)
    mx = take(clusters.centroid_x, ai)
    my = take(clusters.centroid_y, ai)
    me = take(cluster_entropy, ai)

    # Alpha-beta update for matched, coast for unmatched-active.
    rx = mx - px
    ry = my - py
    nx = torch.where(matched, px + config.alpha * rx, px)
    ny = torch.where(matched, py + config.alpha * ry, py)
    nvx = torch.where(matched, state.vx + config.beta * rx, state.vx)
    nvy = torch.where(matched, state.vy + config.beta * ry, state.vy)
    hits = torch.where(matched, state.hits + 1, state.hits)
    misses = torch.where(matched, 0, state.misses + state.active.to(torch.int32))
    ent = torch.where(matched, 0.7 * state.entropy + 0.3 * me, state.entropy)
    active = state.active & (misses <= config.max_misses)

    # Detections already taken by a track. The reference scatters
    # ``matched`` into ``ai`` with duplicate indices (every unmatched
    # track clips to slot 0) and the last write wins, so the
    # highest-index track with ``ai == j`` decides ``det_used[j]``;
    # reproduced here with a deterministic max-reduce and a gather.
    tracks = torch.arange(t, device=dev).expand(*lead, t)
    last = torch.full(lead + (k,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        -1, ai, tracks, reduce="amax"
    )
    det_used = (last >= 0) & take(matched, torch.clamp(last, 0))
    det_free = clusters.valid & ~det_used
    slot_free = ~active
    # Pair free slots with free detections by rank.
    slot_rank = torch.cumsum(slot_free.to(torch.int32), -1) - 1  # (..., T)
    det_rank = torch.cumsum(det_free.to(torch.int32), -1) - 1  # (..., K)
    # Detection id for each rank. Free ranks are unique; every non-free
    # detection lands in a dump slot past any rank a track slot reads.
    dst = torch.where(det_free, det_rank, t + k - 1).to(torch.int64)
    det_for_rank = torch.full(lead + (t + k,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        -1, dst, torch.arange(k, device=dev).expand(*lead, k), reduce="amax"
    )
    spawn_det = torch.where(
        slot_free, take(det_for_rank, torch.clamp(slot_rank, 0, t + k - 1).to(torch.int64)), -1
    )
    do_spawn = slot_free & (spawn_det >= 0)
    si = torch.clamp(spawn_det, 0, k - 1)
    nx = torch.where(do_spawn, take(clusters.centroid_x, si), nx)
    ny = torch.where(do_spawn, take(clusters.centroid_y, si), ny)
    nvx = torch.where(do_spawn, 0.0, nvx)
    nvy = torch.where(do_spawn, 0.0, nvy)
    hits = torch.where(do_spawn, 1, hits)
    misses = torch.where(do_spawn, 0, misses)
    ent = torch.where(do_spawn, take(cluster_entropy, si), ent)
    age = torch.where(do_spawn, 0, state.age + active.to(torch.int32))
    active = active | do_spawn

    new = TrackState(
        nx, ny, nvx, nvy, hits.to(torch.int32), misses.to(torch.int32),
        age.to(torch.int32), active, ent,
    )
    return new, assign


def confirmed(state: TrackState, config: TrackerConfig = TrackerConfig()) -> torch.Tensor:
    """(T,) bool: tracks that passed the spatial-coherence stage."""
    return state.active & (state.hits >= config.confirm_hits)


def track_recording(
    clusters_seq: Clusters,
    entropy_seq: torch.Tensor,
    config: TrackerConfig = TrackerConfig(),
    init: TrackState | None = None,
) -> tuple[TrackState, TrackState]:
    """Run the tracker over ``(W, ..., K)`` stacked clusters (leading dims
    after the window axis batch sensors). Returns the final state and the
    ``(W, ..., T)`` stacked state after each window. Runs inside a
    ``record_function("tracker")`` range."""
    state = init_tracks(config, clusters_seq.valid.device) if init is None else init
    states = []
    with record_function("tracker"):
        for w in range(clusters_seq.valid.shape[0]):
            cl = Clusters(*(a[w] for a in clusters_seq))
            state, _ = tracker_step(state, cl, entropy_seq[w], config)
            states.append(state)
    if not states:
        return state, TrackState(*(a[None][:0] for a in state))
    return state, TrackState(*(torch.stack(f) for f in zip(*states)))
