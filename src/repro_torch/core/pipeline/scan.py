"""The step core with a carry, and the whole-recording driver.

The port of ``repro.core.pipeline.scan``. The central object is the step
core built by :func:`make_core`:

    core(batch, state, atlas, tag0) -> (final, clusters, mets, states, atlas)

over ``(W, E)`` windows of one sensor or ``(S, W, E)`` windows of a
fleet: conditioning, clustering and metrics run over the flattened
windows in blocks of ``window_core.WINDOW_BLOCK`` on the device, then the
tracker, the one stage with a carry, runs from ``state`` as a loop over
the window axis, every sensor at once. The float event route
(``metrics_impl="event"``, the default) is the atlas event core
(``event_core.py``): it also writes the persistent window-tagged atlas,
equal to the reference's to the bit, from the window tags ``tag0 + w``.
The straight core (``metrics_impl="frame"`` or ``"kernel"``) and the
fixed-point core (``numerics="fixed"``) carry the atlas untouched, as the
reference's do. The atlas has the reference's shape, so carries convert
across the two packages. :func:`run_recording_scan` is one core call
over a whole recording with a fresh carry; :func:`run_many_scan` one
core call over a batch of recordings, their windows stacked along a
leading recording axis, each with its own atlas; the streaming and fleet
drivers call the core feed after feed.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.events import EventBatch, WindowedEvents, pad_windows
from repro_torch.core.grid_clustering import Clusters
from repro_torch.core.pipeline.config import (
    PipelineConfig,
    _histogram_fn,
    _metrics_fn,
    atlas_shape,
    check_supported,
)
from repro_torch.core.pipeline.event_core import make_event_core
from repro_torch.core.pipeline.window_core import (
    WindowResult,
    _fixed_window_core,
    _flat_blocks,
    _gather_and_track,
    _window_core,
)
from repro_torch.core.tracking import TrackState, init_tracks

if TYPE_CHECKING:
    from repro_torch.data.synthetic import Recording

@dataclasses.dataclass
class ScanResult:
    """Stacked outputs: ``clusters`` leaves and ``metrics`` values are
    ``(W, K)``; ``tracks`` leaves (with tracking on) are ``(W, T)``, the
    state after each window. Tensors stay on the run's device."""

    t_start_us: np.ndarray  # (W,) int64
    clusters: Clusters  # leaves (W, K)
    metrics: dict[str, torch.Tensor]  # (W, K)
    tracks: TrackState | None  # leaves (W, T)
    final_tracks: TrackState | None
    windows: WindowedEvents

    @property
    def num_windows(self) -> int:
        return int(self.t_start_us.shape[0])

    def window_results(self) -> list[WindowResult]:
        """The loop driver's per-window list (metrics copied to the host),
        for window-by-window comparisons."""
        mets = {k: v.cpu().numpy() for k, v in self.metrics.items()}
        return [
            WindowResult(
                t_start_us=int(self.t_start_us[w]),
                clusters=Clusters(*(a[w] for a in self.clusters)),
                metrics={k: v[w] for k, v in mets.items()},
                tracks=None if self.tracks is None else TrackState(*(a[w] for a in self.tracks)),
            )
            for w in range(self.num_windows)
        ]


def make_atlas(
    config: PipelineConfig,
    capacity: int | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Fresh (all-stale) tagged event atlas; rides the stream's carry."""
    return torch.zeros(atlas_shape(config, capacity), dtype=torch.int32,
                       device=resolve_device(device))


def make_core(config: PipelineConfig, with_tracking: bool = True):
    """The step core for ``config``:

        core(batch, state, atlas, tag0) ->
            (final, clusters, mets, states, atlas)

    ``batch`` leaves are ``(W, E)`` or ``(S, W, E)``, ``state`` leaves
    ``(T,)`` or ``(S, T)``, ``atlas`` ``(H+1, max(width, E))`` or ``(S,
    H+1, max(width, E))``. Returns the tracker state after the last window,
    ``(..., W, K)`` clusters and metrics, the ``(..., W, T)`` state after
    each window (``None`` without tracking; ``final`` is then ``state``)
    and the atlas. ``numerics="float", metrics_impl="event"`` is the atlas
    event core (:func:`~repro_torch.core.pipeline.event_core.make_event_core`),
    which writes the atlas from the window tags ``tag0 + w``; the frame
    and kernel routes and the fixed datapath run the straight core, which
    returns the atlas untouched, as the reference's do."""
    check_supported(config)
    if config.numerics == "fixed":
        window_fn = lambda batch: _fixed_window_core(config, batch)  # noqa: E731
    elif config.metrics_impl == "event":
        return make_event_core(config, with_tracking)
    else:
        hist_fn, metrics_fn = _histogram_fn(config), _metrics_fn(config)
        window_fn = lambda batch: _window_core(config, hist_fn, metrics_fn, batch)  # noqa: E731

    def core(batch: EventBatch, state: TrackState, atlas: torch.Tensor, tag0=0):
        del tag0  # only the atlas event core tags windows
        parts = [window_fn(block) for _, block in _flat_blocks(batch)]
        return (*_gather_and_track(config, with_tracking, batch.x.shape[:-1], parts, state), atlas)

    return core


def run_recording_scan(
    recording: Recording,
    config: PipelineConfig = PipelineConfig(),
    with_tracking: bool = True,
    windows: WindowedEvents | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> ScanResult:
    """Run the detection chain over a whole recording on ``device``.

    Windows are the reference's dual-threshold windows. Pass precomputed
    ``windows`` (from :func:`pad_windows` on the same device) to skip the
    host windowing pass.
    """
    dev = resolve_device(device)
    core = make_core(config, with_tracking)
    if windows is None:
        windows = pad_windows(
            recording.x, recording.y, recording.t, recording.p, config.batcher, dev
        )
    final, clusters, mets, states, _ = core(
        windows.batch, init_tracks(config.tracker, dev),
        make_atlas(config, windows.capacity, dev), 0,
    )
    if not with_tracking:
        final = None
    return ScanResult(
        t_start_us=windows.t_start_us,
        clusters=clusters,
        metrics=mets,
        tracks=states,
        final_tracks=final,
        windows=windows,
    )


def _many_scan_raw(
    recordings: list[Recording],
    config: PipelineConfig,
    with_tracking: bool,
    device: str | torch.device = DEFAULT_DEVICE,
) -> tuple[list[WindowedEvents], tuple]:
    """Window each recording on the host, right-pad every one with empty
    (all-invalid) windows to the longest one's count, stack them into
    ``(R, W_max, capacity)`` planes (one copy to ``device`` per plane) and
    run the core once from a fresh carry per recording. Returns the
    per-recording windowing (planes on the host) and the untrimmed core
    outputs ``(final, clusters, mets, states)``, leaves ``(R, W_max, ...)``."""
    dev = resolve_device(device)
    windowed = [pad_windows(r.x, r.y, r.t, r.p, config.batcher, "cpu") for r in recordings]
    w_max = max(w.num_windows for w in windowed)

    def pad_leaf(a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, a.new_zeros((w_max - a.shape[0],) + a.shape[1:])])

    stacked = EventBatch(*(
        torch.stack([pad_leaf(getattr(w.batch, f)) for w in windowed]).to(dev)
        for f in EventBatch._fields
    ))
    fresh = init_tracks(config.tracker, dev)
    state = TrackState(*(a.new_zeros((len(recordings),) + tuple(a.shape)) for a in fresh))
    # One fresh atlas a recording, along the leading recording axis.
    atlas = torch.zeros((len(recordings),) + atlas_shape(config, windowed[0].capacity),
                        dtype=torch.int32, device=dev)
    final, clusters, mets, states, _ = make_core(config, with_tracking)(stacked, state, atlas, 0)
    return windowed, (final, clusters, mets, states)


def run_many_scan(
    recordings: list[Recording],
    config: PipelineConfig = PipelineConfig(),
    with_tracking: bool = True,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[ScanResult]:
    """One core call over a batch of recordings on ``device``: windowed
    on the host, padded with empty windows to a common count and stacked,
    so the window stages run over every recording's windows in blocks and
    the tracker steps every recording at once. Results are split back per
    recording and trimmed to its own windows; with tracking,
    ``final_tracks`` is the state after its last real window, not after
    the padded tail."""
    if not recordings:
        return []
    windowed, (_, clusters, mets, states) = _many_scan_raw(
        recordings, config, with_tracking, device)
    results: list[ScanResult] = []
    for r, w in enumerate(windowed):
        n = w.num_windows
        if not with_tracking:
            final_r = None
        elif n == 0:
            final_r = init_tracks(config.tracker, clusters.count.device)
        else:
            final_r = TrackState(*(a[r, n - 1] for a in states))
        results.append(ScanResult(
            t_start_us=w.t_start_us,
            clusters=Clusters(*(a[r, :n] for a in clusters)),
            metrics={k: v[r, :n] for k, v in mets.items()},
            tracks=TrackState(*(a[r, :n] for a in states)) if with_tracking else None,
            final_tracks=final_r,
            windows=w,
        ))
    return results
