"""The per-window stage (conditioning -> clustering -> metrics), and the
loop driver.

The port of ``repro.core.pipeline.window_core``. ``_condition``,
``_cluster`` and ``_window_core`` are written over a window axis: the stages
of one window do not depend on another window's, so each runs over a
whole ``(W, E)`` block of windows at once, and each kernel launches once
per block, not once per window: on the float kernel route
(``use_kernels=True, metrics_impl="kernel"``) the clustering and the
metrics stage are one launch each. Each stage runs inside a
``torch.profiler.record_function`` range named after it, so a profile
of any entry point splits its time by stage; the fixed datapath's
megakernel runs inside one range, ``"fixed window core"``.

:func:`run_recording` is the loop driver: the reference's dual-threshold
windows one at a time, each through the window core as a ``(1, E)``
block (so on the kernel routes each kernel launches once per window),
then one tracker step, with a host copy of the metrics per window. Its
metrics stage is the configured route's (``_metrics_fn``: event, frame or
kernel); like the reference's loop driver it has no atlas. The
per-window stage and the tracker step are memoized per config
(:func:`make_process_window`, :func:`_tracker_fn`), as in the reference.
It is the baseline the scan and stream drivers are held to, window for
window.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.events import (
    EventBatch,
    dual_threshold_batches,
    persistent_event_filter,
    roi_filter,
)
from repro_torch.core.fixed_point import fixed_window_stage
from repro_torch.core.grid_clustering import Clusters, clusters_from_histogram, merge_adjacent
from repro_torch.core.pipeline.config import (
    PipelineConfig,
    _histogram_fn,
    _metrics_fn,
    check_supported,
)
from repro_torch.core.tracking import (
    TrackerConfig,
    TrackState,
    init_tracks,
    track_recording,
    tracker_step,
)

if TYPE_CHECKING:
    from repro_torch.data.synthetic import Recording

# Windows per block through the stateless stages: bounds the device
# memory of one block (about 4 MB of event planes per 1024 windows)
# while keeping a launch per kernel per block.
WINDOW_BLOCK = 4096


def _condition(config: PipelineConfig, batch: EventBatch) -> EventBatch:
    batch = roi_filter(batch, config.roi)
    return persistent_event_filter(batch, config.hot_pixel_max)


def _cluster(
    config: PipelineConfig, hist_fn: Callable[[EventBatch], tuple], batch: EventBatch
) -> Clusters:
    """Top-K clusters of ``(W, E)`` windows. Under ``use_kernels`` the
    whole stage is one kernel launch (``ops.cluster_accum_topk``); else
    ``hist_fn``'s cell rows, then :func:`clusters_from_histogram`."""
    if config.use_kernels:
        from repro_torch.kernels import ops as kops

        clusters = kops.cluster_accum_topk(batch.x, batch.y, batch.t, batch.valid, config.grid)
    else:
        clusters = clusters_from_histogram(*hist_fn(batch), config.grid)
    if config.merge_neighbors:
        clusters = merge_adjacent(clusters, config.grid)
    return clusters


def _window_core(
    config: PipelineConfig,
    hist_fn: Callable[[EventBatch], tuple],
    metrics_fn: Callable[[EventBatch, Clusters], dict[str, torch.Tensor]],
    batch: EventBatch,
) -> tuple[Clusters, dict[str, torch.Tensor]]:
    """Conditioning, clustering and metrics over ``(W, E)`` windows;
    returns ``(W, K)`` clusters and metrics."""
    with record_function("conditioning"):
        batch = _condition(config, batch)
    with record_function("clustering"):
        clusters = _cluster(config, hist_fn, batch)
    with record_function("metrics"):
        return clusters, metrics_fn(batch, clusters)


def _fixed_window_core(
    config: PipelineConfig, batch: EventBatch
) -> tuple[Clusters, dict[str, torch.Tensor]]:
    """The ``numerics="fixed"`` stage over ``(W, E)`` windows: the
    megakernel (``metrics_impl="megakernel"``) or the staged integer
    path; returns dequantized ``(W, K)`` clusters and metrics."""
    if config.metrics_impl == "megakernel":
        from repro_torch.kernels import ops as kops

        with record_function("fixed window core"):
            fc, mets, _ = kops.window_pipeline(batch, config)
    else:
        fc, mets = fixed_window_stage(config, batch)
    return fc.to_clusters(), mets


def _flat_blocks(batch: EventBatch):
    """The ``(..., W, E)`` windows flattened to ``(n, E)`` and cut into
    :data:`WINDOW_BLOCK`-window blocks: ``(lo, block)`` pairs (one empty
    block when there is no window)."""
    e = batch.x.shape[-1]
    flat = EventBatch(*(a.reshape(-1, e) for a in batch))
    n = flat.x.shape[0]
    return [(lo, EventBatch(*(a[lo:lo + WINDOW_BLOCK] for a in flat)))
            for lo in range(0, max(n, 1), WINDOW_BLOCK)]


def _gather_and_track(config, with_tracking, lead, parts, state):
    """Concatenate the blocks' ``(clusters, mets)`` back to ``(..., W, K)``
    and run the tracker from ``state`` over the window axis, every sensor
    at once. Returns ``(final, clusters, mets, states)``."""
    unflat = lambda a: a.reshape(*lead, *a.shape[1:])  # noqa: E731
    clusters = Clusters(*(unflat(torch.cat(f)) for f in zip(*(p[0] for p in parts))))
    mets = {k: unflat(torch.cat([p[1][k] for p in parts])) for k in parts[0][1]}
    if not with_tracking:
        return state, clusters, mets, None
    axis = len(lead) - 1
    final, states = track_recording(
        Clusters(*(a.movedim(axis, 0) for a in clusters)),
        mets["shannon_entropy"].movedim(axis, 0), config.tracker, state,
    )
    return final, clusters, mets, TrackState(*(a.movedim(0, axis) for a in states))


def _one_window(window_fn: Callable[[EventBatch], tuple]) -> Callable[[EventBatch], tuple]:
    """``window_fn`` over ``(W, E)`` windows as a function of one ``(E,)``
    window: it runs as a ``(1, E)`` block, and the ``(K,)`` clusters and
    metrics come back."""

    def process_window(batch: EventBatch) -> tuple[Clusters, dict[str, torch.Tensor]]:
        clusters, mets = window_fn(EventBatch(*(a[None] for a in batch)))
        return Clusters(*(a[0] for a in clusters)), {k: v[0] for k, v in mets.items()}

    return process_window


@functools.lru_cache(maxsize=None)
def make_process_window(config: PipelineConfig = PipelineConfig()):
    """The per-window stage for ``config``: one ``(E,)`` window in,
    ``(K,)`` clusters and the metric dict out, on the window's device.
    Memoized per config, as the reference's jit'd closure is."""
    check_supported(config)
    if config.numerics == "fixed":
        from repro_torch.core.fixed_point import make_fixed_process_window

        return make_fixed_process_window(config)
    hist_fn, metrics_fn = _histogram_fn(config), _metrics_fn(config)
    return _one_window(lambda batch: _window_core(config, hist_fn, metrics_fn, batch))


@functools.lru_cache(maxsize=None)
def _tracker_fn(config: TrackerConfig):
    """The tracker step for ``config`` (memoized per tracker config)."""
    return functools.partial(tracker_step, config=config)


@dataclasses.dataclass
class WindowResult:
    t_start_us: int
    clusters: Clusters  # (K,) tensors on the run's device
    metrics: dict[str, np.ndarray]
    tracks: TrackState | None = None


def run_recording(
    recording: Recording,
    config: PipelineConfig = PipelineConfig(),
    with_tracking: bool = True,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[WindowResult]:
    """The loop driver on ``device``: dual-threshold windows one at a
    time, each through the window core and the tracker, the metrics
    copied to the host per window. See :func:`run_recording_scan` for one
    call over the whole recording."""
    dev = resolve_device(device)
    process_window = make_process_window(config)
    tracker_fn = _tracker_fn(config.tracker)
    state = init_tracks(config.tracker, dev)
    results: list[WindowResult] = []
    for batch, sl in dual_threshold_batches(
        recording.x, recording.y, recording.t, recording.p, config.batcher, dev
    ):
        clusters, mets = process_window(batch)
        if with_tracking:
            state, _ = tracker_fn(state, clusters, mets["shannon_entropy"])
        results.append(WindowResult(
            t_start_us=int(recording.t[sl.start]),
            clusters=clusters,
            metrics={k: v.cpu().numpy() for k, v in mets.items()},
            tracks=state if with_tracking else None,
        ))
    return results
